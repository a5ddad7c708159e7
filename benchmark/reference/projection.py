"""The Defense-GAN projection, plain: z* = argmin_z ||G(z) - x||^2.

Samangouei et al., "Defense-GAN" (arXiv:1805.06605), section 3.2, with
the reference implementation's optimizer (github.com/kabkabm/defensegan,
models/gan.py::reconstruct, tf.train.MomentumOptimizer): x is mapped to
tanh space (2x - 1) and tiled over R restarts; L steps of
v <- m v + g; z <- z - lr v, where g is the gradient of the SUM over
rows of each row's mean squared error; per image the restart with the
lowest final loss wins (the first on ties) and x_hat = (G(z*) + 1) / 2.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Projection(NamedTuple):
    z_final: torch.Tensor    # [B, R, k]
    losses: torch.Tensor     # [B, R] final loss of every restart
    best: torch.Tensor       # [B] index of the winning restart
    x_hat: torch.Tensor      # [B, H, W, C] in [0, 1]


def row_losses(out: torch.Tensor, x_rows: torch.Tensor) -> torch.Tensor:
    d = out.reshape(out.shape[0], -1) - x_rows
    return (d * d).mean(1)


def project(gen: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
            z0: torch.Tensor, *, iters: int, lr: float,
            momentum: float) -> Projection:
    """x [B, H, W, C] in [0, 1]; z0 [B, R, k]; gen: z -> tanh images."""
    b, r, k = z0.shape
    x_t = (2.0 * x.float() - 1.0).reshape(b, -1)
    x_rows = x_t[:, None].expand(b, r, x_t.shape[1]).reshape(b * r, -1)
    z = z0.reshape(b * r, k).float().clone()
    v = torch.zeros_like(z)
    for _ in range(iters):
        zg = z.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = row_losses(gen(zg), x_rows).sum()
            (g,) = torch.autograd.grad(loss, zg)
        v = momentum * v + g
        z = z - lr * v
    with torch.no_grad():
        losses = row_losses(gen(z), x_rows).reshape(b, r)
        best = torch.argmin(losses, dim=1)
        z_final = z.reshape(b, r, k)
        z_star = z_final[torch.arange(b, device=z.device), best]
        x_hat = (gen(z_star) + 1.0) * 0.5
    return Projection(z_final=z_final, losses=losses, best=best,
                      x_hat=x_hat)
