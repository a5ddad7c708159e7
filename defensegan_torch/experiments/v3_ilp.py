"""Experiment: the deep loop v3 as two independent chains.

Port of scripts/pallas_v3_ilp_exp.py, an experiment the JAX package keeps
as a record (on a TPU v5e a tie with v3: RESULTS.md). The TPU kernel runs
v3's step on two independent 32-latent subtiles per grid step, so that
the compiler can overlap one subtile's vector stages with the other's
matrix products. On the H100 the same lever is two step chains in flight:
the chunk's rows in two halves, each on its own CUDA stream, their
launches issued in turns step by step from the library's L loop
(csrc/fused_projection_v3_variants.cu, fp_v3_ilp_run), so that one
half's non-product launches (tanh_grad_pack, the split-K sum, a conv's
tail) run beside the other half's wgmma products. Every row's arithmetic
is v3's: z_final equals v3's bit for bit.

`fused_projection_ilp` runs the loop: on a CUDA tensor through the
kernel, on a CPU tensor through `ilp_loop_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from defensegan_torch.kernels.fused_projection_v2 import ROW_TILE
from defensegan_torch.kernels.fused_projection_v3 import (
    S2DPack, check_targets, make_s2d_reconstructor, run_s2d, s2d_loop_plain)

LIBRARY = "fused_projection_v3_variants"
COUNTER = "fused_projection_v3_ilp"      # build.LAUNCHES key of this wrapper


def halves(n: int) -> int:
    """Rows of the first chain: half of n rounded up to the 64-row tile
    (n itself up to 64 rows: one chain), as the kernel splits a chunk."""
    return n if n <= ROW_TILE else -(-(n // 2) // ROW_TILE) * ROW_TILE


def ilp_loop_plain(pack: S2DPack, x_s2d: torch.Tensor, z0: torch.Tensor, *,
                   rec_iters: int, rec_lr: float,
                   momentum: float) -> torch.Tensor:
    """Plain PyTorch version: v3's plain loop on each chain's rows."""
    m0 = halves(z0.shape[0])
    kw = dict(rec_iters=rec_iters, rec_lr=rec_lr, momentum=momentum)
    parts = [s2d_loop_plain(pack, x_s2d[:m0], z0[:m0], **kw)]
    if m0 < z0.shape[0]:
        parts.append(s2d_loop_plain(pack, x_s2d[m0:], z0[m0:], **kw))
    return torch.cat(parts)


def fused_projection_ilp(pack: S2DPack, x_s2d: torch.Tensor,
                         z0_flat: torch.Tensor, *, rec_iters: int,
                         rec_lr: float, momentum: float,
                         chunk: Optional[int] = None) -> torch.Tensor:
    """Run the loop for all N latents; returns z_final [N, k]. v3's
    interface (x_s2d [N, 49*cb] in s2d-flat order, z0_flat [N, k]); a CPU
    tensor runs the plain version, a CUDA tensor launches the kernel or
    raises."""
    check_targets(pack, x_s2d, z0_flat)
    if z0_flat.device.type == "cpu":
        return ilp_loop_plain(pack, x_s2d, z0_flat, rec_iters=rec_iters,
                              rec_lr=rec_lr, momentum=momentum)
    return run_s2d(pack, x_s2d, z0_flat, rec_iters=rec_iters, rec_lr=rec_lr,
                   momentum=momentum, chunk=chunk, library=LIBRARY,
                   entry="fp_v3_ilp_run", counter=COUNTER)


def make_ilp_reconstructor(generator, image_shape, *, rec_rr: int,
                           rec_iters: int, rec_lr: float, momentum: float):
    """f(x, gen=None, z0=None) -> ReconstructionResult on the two-chain
    loop: v3's reconstructor with only the loop changed."""
    return make_s2d_reconstructor(
        generator, image_shape, rec_rr=rec_rr, rec_iters=rec_iters,
        rec_lr=rec_lr, momentum=momentum, loop=fused_projection_ilp)
