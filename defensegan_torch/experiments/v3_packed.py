"""Experiment: the deep loop v3 with conv A's taps packed into one product.

Port of scripts/pallas_v3_packed_exp.py, an experiment the JAX package
keeps as a record (on a TPU v5e it was slower than v3: RESULTS.md). The
TPU kernel concatenates conv A's nine shifted inputs and contracts them
in ONE product each way, [rows, 9*c0] @ [9*c0, ca] forward and
[rows, 9*ca] @ [9*ca, c0] backward, where v3 issues nine. On the H100 the
port's v3 already sums the forward's taps in one chain (csrc/
fused_projection_v3.cu), so what changes is the backward: one chain over
K = 9*ca, rounded to bf16 once, after the sum, where v3 rounds each tap's
product (the TPU kernel's layout artefact that v3 keeps). In the kernel
that is the grid conv's tap-sum mode (TapSum kChain under kBackward,
csrc/conv3x3_sm90.cuh). Its conv B section runs as one kernel
(csrc/fused_projection_v3_step.cuh, convb::section; v3 runs it too where
the shapes allow), where the three-launch form passes the packed product
and the packed do through device memory: the same function, rounding for
rounding, so the packed loop's z_final is what those three launches
give, bit for bit.

`run_packed` runs the loop: on a CUDA tensor through the hand-written
kernel (csrc/fused_projection_v3_variants.cu, fp_v3_packed_run), on a CPU
tensor through `packed_loop_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from defensegan_torch.kernels.fused_projection_v3 import (
    S2DPack, check_targets, fused_projection_s2d, s2d_loop_plain, s2d_state)

LIBRARY = "fused_projection_v3_variants"
COUNTER = "fused_projection_v3_packed"   # build.LAUNCHES key of this wrapper
FUSED_CONV_B = True                      # conv B's section: one launch


def packed_loop_plain(pack: S2DPack, x_s2d: torch.Tensor, z0: torch.Tensor,
                      *, rec_iters: int, rec_lr: float,
                      momentum: float) -> torch.Tensor:
    """Plain PyTorch version: v3's plain loop with conv A's backward
    rounded once, after the sum of its taps."""
    return s2d_loop_plain(pack, x_s2d, z0, rec_iters=rec_iters,
                          rec_lr=rec_lr, momentum=momentum, round_taps=False)


def run_packed(pack: S2DPack, x_s2d: torch.Tensor, z0_flat: torch.Tensor, *,
               rec_iters: int, rec_lr: float, momentum: float,
               chunk: Optional[int] = None,
               fused: bool = FUSED_CONV_B) -> torch.Tensor:
    """Run the loop for all N latents; returns z_final [N, k]. v3's
    interface (x_s2d [N, 49*cb] in s2d-flat order, z0_flat [N, k]); a CPU
    tensor runs the plain version, a CUDA tensor launches the kernel or
    raises. fused=False: conv B's section as v3's three launches
    (fp_v3_packed_launches_run, the design before the fused kernel)."""
    check_targets(pack, x_s2d, z0_flat)
    if z0_flat.device.type == "cpu":
        return packed_loop_plain(pack, x_s2d, z0_flat, rec_iters=rec_iters,
                                 rec_lr=rec_lr, momentum=momentum)
    return fused_projection_s2d(
        pack, x_s2d, z0_flat, rec_iters=rec_iters, rec_lr=rec_lr,
        momentum=momentum, chunk=chunk,
        state=s2d_state(pack, library=LIBRARY,
                        entry="fp_v3_packed_run" if fused
                        else "fp_v3_packed_launches_run",
                        fused_conv_b=fused)._replace(counter=COUNTER))
