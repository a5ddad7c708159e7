"""WGAN-GP losses (port of the JAX package's gan/losses.py).

Reference parity: the WGAN training objective of models/gan.py of
kabkabm/defensegan, with the gradient penalty of Gulrajani et al.,
"Improved Training of Wasserstein GANs" (arXiv:1704.00028): lambda 10.
All functions work in the generator's [-1, 1] tanh space; `critic` maps
images [N, H, W, C] to scores [N].
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

CriticApply = Callable[[torch.Tensor], torch.Tensor]


def gradient_penalty(critic: CriticApply, real: torch.Tensor,
                     fake: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """E[(||grad_xhat D(xhat)||_2 - 1)^2], xhat = eps real + (1 - eps) fake.

    eps: [N], one U[0, 1] value per sample. xhat and the norm are float32
    whatever the critic's compute dtype (a second-order quantity: bf16 is
    too coarse); the input gradient keeps its graph (create_graph), so the
    penalty is differentiable with respect to the critic's parameters.
    The norm is sqrt(sum g^2 + 1e-12), finite in its gradient at g = 0.
    """
    eps = eps.reshape((-1,) + (1,) * (real.dim() - 1)).to(torch.float32)
    x_hat = eps * real.to(torch.float32) + (1.0 - eps) * fake.to(
        torch.float32)
    if not x_hat.requires_grad:
        x_hat.requires_grad_(True)
    (grads,) = torch.autograd.grad(critic(x_hat).sum(), x_hat,
                                   create_graph=True)
    norms = torch.sqrt(torch.sum(torch.square(grads.to(torch.float32)),
                                 dim=tuple(range(1, grads.dim()))) + 1e-12)
    return torch.mean(torch.square(norms - 1.0))


def critic_loss_fn(critic: CriticApply, real: torch.Tensor,
                   fake: torch.Tensor, eps: torch.Tensor,
                   gp_lambda: float = 10.0
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """WGAN-GP critic loss E[D(fake)] - E[D(real)] + lambda GP, and its
    terms (d_real, d_fake, gp, wasserstein = d_real - d_fake)."""
    d_real = torch.mean(critic(real))
    d_fake = torch.mean(critic(fake))
    gp = gradient_penalty(critic, real, fake, eps)
    loss = d_fake - d_real + gp_lambda * gp
    return loss, {"d_real": d_real, "d_fake": d_fake, "gp": gp,
                  "wasserstein": d_real - d_fake}


def generator_loss_fn(critic: CriticApply,
                      fake: torch.Tensor) -> torch.Tensor:
    """WGAN generator loss -E[D(G(z))]."""
    return -torch.mean(critic(fake))
