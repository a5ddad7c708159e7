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
happens inside. back_prop=True makes the result differentiable with
respect to x (and z0) through all L unrolled steps, as the white-box
attacks need: each step's gradient is taken with create_graph=True, a
second-order pass through the generator, and each step runs under
torch.utils.checkpoint (non-reentrant), the counterpart of the JAX
package's jax.checkpoint on the scan body: the graph keeps each step's
inputs (z, v) and recomputes the step's generator activations in the
backward pass, so memory grows as O(L * |z|), not O(L * activations).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from defensegan_torch.models.generator import from_image_space, \
    to_image_space
from defensegan_torch.utils.profiling import span

GenApply = Callable[[torch.Tensor], torch.Tensor]


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


def _step(gen_apply: GenApply, z: torch.Tensor, v: torch.Tensor,
          x_flat: torch.Tensor, momentum: float, rec_lr: float,
          create_graph: bool):
    """One momentum step: g = d/dz sum_i mse_i; v <- m v + g; z <- z - lr v.

    create_graph=False detaches z (no graph through the loop);
    create_graph=True keeps the new z and v differentiable in z, v and
    x_flat."""
    if not (create_graph and z.requires_grad):
        z = z.detach()
    zr = z if z.requires_grad else z.requires_grad_(True)
    with torch.enable_grad():
        loss = torch.sum(rec_losses(gen_apply, zr, x_flat))
        (g,) = torch.autograd.grad(loss, zr, create_graph=create_graph)
    v = momentum * v + g
    return (zr if create_graph else z.detach()) - rec_lr * v, v


def reconstruct(gen_apply: GenApply, x: torch.Tensor, z0: torch.Tensor, *,
                rec_iters: int = 200, rec_lr: float = 10.0,
                momentum: float = 0.7,
                back_prop: bool = False) -> ReconstructionResult:
    """Project x onto the generator manifold with autograd gradients.

    gen_apply: frozen generator, z [N, k] -> tanh-space images (NHWC or
    flat, matching x's layout). x: [B, ...] images in [0, 1] or uint8.
    z0: [B, R, k] initial latents. back_prop=True: the result carries
    gradients to x and z0 through the whole loop (module docstring);
    otherwise it is detached, as the JAX package stops its gradients.
    Under a torch.profiler the L steps are a projection.loop span, the
    final losses and the selection a projection.select span.
    """
    batch, rr, z_dim = z0.shape
    x_flat = tile_restarts(from_image_space(x), rr)
    z = z0.reshape(batch * rr, z_dim).to(torch.float32)
    v = torch.zeros_like(z)
    if not back_prop:
        with span("projection.loop"):
            for _ in range(rec_iters):
                z, v = _step(gen_apply, z, v, x_flat, momentum, rec_lr,
                             False)
        with torch.no_grad(), span("projection.select"):
            losses = rec_losses(gen_apply, z, x_flat).reshape(batch, rr)
            return select_restarts(losses, z, gen_apply)

    def step(z, v, x_flat):
        return _step(gen_apply, z, v, x_flat, momentum, rec_lr, True)

    with torch.enable_grad():
        with span("projection.loop"):
            for _ in range(rec_iters):
                z, v = checkpoint(step, z, v, x_flat, use_reentrant=False)
        with span("projection.select"):
            losses = rec_losses(gen_apply, z, x_flat).reshape(batch, rr)
            return select_restarts(losses, z, gen_apply)


def make_reconstructor(gen_apply: GenApply, *, rec_rr: int = 10,
                       rec_iters: int = 200, rec_lr: float = 10.0,
                       momentum: float = 0.7, back_prop: bool = False,
                       z_dim: int = 128, device=None):
    """Return f(x, gen=None, z0=None) -> ReconstructionResult.

    z0 ([B, R, k]) overrides sampling from the torch.Generator `gen`.
    """

    def run(x, gen: Optional[torch.Generator] = None, z0=None):
        if z0 is None:
            z0 = sample_z0(gen, x.shape[0], rec_rr, z_dim,
                           device=device or x.device)
        return reconstruct(gen_apply, x, z0, rec_iters=rec_iters,
                           rec_lr=rec_lr, momentum=momentum,
                           back_prop=back_prop)

    return run
