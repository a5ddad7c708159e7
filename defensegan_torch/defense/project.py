"""Projection onto the generator manifold: z* = argmin_z ||G(z) - x||^2.

Port of the JAX package's defense/project.py (reference: models/gan.py::
DefenseGANBase.reconstruct of kabkabm/defensegan):

  - x is tiled across R restarts and folded into the batch axis,
    z0 ~ N(0, I) of shape [B, R, k];
  - L steps of momentum gradient descent with tf.train.MomentumOptimizer
    semantics, v <- m * v + g; z <- z - lr * v, on the per-image mean
    squared error in tanh space (the gradient is that of the SUM of the
    per-image means);
  - per image, the restart with the lowest FINAL loss wins; ties go to the
    first index, as jnp.argmin and torch.argmin both do.

Images at this API are in [0, 1] (or uint8); the tanh-space conversion
happens inside. back_prop=True (differentiating through the loop, for the
white-box attacks) belongs to the attacks slice and raises here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from defensegan_torch.models.generator import from_image_space, \
    to_image_space

GenApply = Callable[[torch.Tensor], torch.Tensor]

BACK_PROP_TODO = ("back_prop=True (gradients through the projection) is "
                  "not ported yet: it is the attacks slice in ROADMAP.md")


class ReconstructionResult(NamedTuple):
    """x_hat [B, H, W, C] in [0, 1]; z_star [B, k]; loss [B] (tanh-space
    MSE of the winner); all_losses [B, R] (final loss of every restart)."""

    x_hat: torch.Tensor
    z_star: torch.Tensor
    loss: torch.Tensor
    all_losses: torch.Tensor


def sample_z0(gen: Optional[torch.Generator], batch: int, rec_rr: int,
              z_dim: int, device=None,
              dtype=torch.float32) -> torch.Tensor:
    """z0 ~ N(0, I), shape [B, R, k], drawn from `gen` on its own device
    (the CPU when gen is None), then moved to `device` when given."""
    z0 = torch.randn((batch, rec_rr, z_dim), generator=gen,
                     device=gen.device if gen is not None else "cpu",
                     dtype=dtype)
    return z0 if device is None else z0.to(device)


def rec_losses(gen_apply: GenApply, z: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """Per-row mean squared error in tanh space, shape [N]."""
    d = (gen_apply(z) - x).to(torch.float32)
    return torch.mean(torch.square(d), dim=tuple(range(1, d.ndim)))


def tile_restarts(x_tanh: torch.Tensor, rr: int) -> torch.Tensor:
    """[B, ...] -> [B * R, ...], each image repeated R times in a row."""
    b = x_tanh.shape[0]
    return x_tanh[:, None].expand((b, rr) + tuple(x_tanh.shape[1:])) \
        .reshape((b * rr,) + tuple(x_tanh.shape[1:]))


def select_restarts(losses: torch.Tensor, z_final: torch.Tensor,
                    gen_apply: GenApply, image_shape=None
                    ) -> ReconstructionResult:
    """Winner per image from the [B, R] final losses, then G(z*)."""
    batch, rr = losses.shape
    best = torch.argmin(losses, dim=1)
    idx = torch.arange(batch, device=losses.device)
    z_star = z_final.reshape(batch, rr, -1)[idx, best]
    x_hat = to_image_space(gen_apply(z_star))
    if image_shape is not None:
        x_hat = x_hat.reshape((batch,) + tuple(image_shape))
    return ReconstructionResult(x_hat=x_hat, z_star=z_star,
                                loss=losses[idx, best], all_losses=losses)


def reconstruct(gen_apply: GenApply, x: torch.Tensor, z0: torch.Tensor, *,
                rec_iters: int = 200, rec_lr: float = 10.0,
                momentum: float = 0.7,
                back_prop: bool = False) -> ReconstructionResult:
    """Project x onto the generator manifold with autograd gradients.

    gen_apply: frozen generator, z [N, k] -> tanh-space images (NHWC or
    flat, matching x's layout). x: [B, ...] images in [0, 1] or uint8.
    z0: [B, R, k] initial latents.
    """
    if back_prop:
        raise NotImplementedError(BACK_PROP_TODO)
    batch, rr, z_dim = z0.shape
    x_flat = tile_restarts(from_image_space(x), rr)
    z = z0.reshape(batch * rr, z_dim).to(torch.float32)
    v = torch.zeros_like(z)
    with torch.enable_grad():
        for _ in range(rec_iters):
            zr = z.detach().requires_grad_(True)
            loss = torch.sum(rec_losses(gen_apply, zr, x_flat))
            (g,) = torch.autograd.grad(loss, zr)
            v = momentum * v + g
            z = z.detach() - rec_lr * v
    with torch.no_grad():
        losses = rec_losses(gen_apply, z, x_flat).reshape(batch, rr)
        return select_restarts(losses, z, gen_apply)


def make_reconstructor(gen_apply: GenApply, *, rec_rr: int = 10,
                       rec_iters: int = 200, rec_lr: float = 10.0,
                       momentum: float = 0.7, back_prop: bool = False,
                       z_dim: int = 128, device=None):
    """Return f(x, gen=None, z0=None) -> ReconstructionResult.

    z0 ([B, R, k]) overrides sampling from the torch.Generator `gen`.
    """
    if back_prop:
        raise NotImplementedError(BACK_PROP_TODO)

    def run(x, gen: Optional[torch.Generator] = None, z0=None):
        if z0 is None:
            z0 = sample_z0(gen, x.shape[0], rec_rr, z_dim,
                           device=device or x.device)
        return reconstruct(gen_apply, x, z0, rec_iters=rec_iters,
                           rec_lr=rec_lr, momentum=momentum)

    return run
