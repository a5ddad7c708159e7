"""FGSM and RAND+FGSM (port of the JAX package's attacks/fgsm.py).

Reference parity: cleverhans FastGradientMethod as used by whitebox.py of
kabkabm/defensegan (attack_type fgsm / rand_fgsm); RAND+FGSM per the
Defense-GAN paper (arXiv:1805.06605): x' = x + alpha * sign(noise), then
FGSM with eps - alpha. When `logits_fn` includes
reconstruct(back_prop=True), the gradient flows through the whole
unrolled projection (the paper's strongest white-box setting).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

LogitsFn = Callable[[torch.Tensor], torch.Tensor]


def xent_per_example(logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[label], shape [B]."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None])[:, 0]


def input_grad(loss_fn: Callable[[torch.Tensor], torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    """d loss_fn(x) / dx for a scalar loss, x detached first."""
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(loss_fn(xg), xg)
    return g


def fgsm(logits_fn: LogitsFn, x: torch.Tensor, labels: torch.Tensor,
         eps: float, clip_min: float = 0.0, clip_max: float = 1.0,
         targeted: bool = False) -> torch.Tensor:
    """Fast Gradient (Sign) Method: x + eps * sign(grad_x mean xent).

    labels: true labels (untargeted) or target labels (targeted).
    """
    g = input_grad(lambda xx: torch.mean(
        xent_per_example(logits_fn(xx), labels)), x)
    direction = -torch.sign(g) if targeted else torch.sign(g)
    return torch.clamp(x.detach() + eps * direction, clip_min, clip_max)


def rand_fgsm(logits_fn: LogitsFn, x: torch.Tensor, labels: torch.Tensor,
              eps: float, alpha: float,
              gen: Optional[torch.Generator] = None,
              clip_min: float = 0.0, clip_max: float = 1.0,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RAND+FGSM (paper section 4): a random step of alpha, then FGSM with
    eps - alpha. noise (x's shape) replaces the N(0, I) draw from `gen`
    (a generator on x's device)."""
    if alpha >= eps:
        raise ValueError(
            f"rand_fgsm needs alpha < eps (got alpha={alpha}, eps={eps}); "
            f"eps - alpha would be a non-positive FGSM step")
    if noise is None:
        noise = torch.randn(x.shape, generator=gen, device=x.device,
                            dtype=x.dtype)
    x_rand = torch.clamp(x + alpha * torch.sign(noise), clip_min, clip_max)
    return fgsm(logits_fn, x_rand, labels, eps - alpha, clip_min, clip_max)
