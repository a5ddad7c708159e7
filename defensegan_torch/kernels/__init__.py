"""Hand-written CUDA kernels for the projection hot loop, and their wrappers.

  - fused_projection_v2: the wide single-deconv generator's L-step loop as
    four bf16 tensor-core GEMMs per step with fused epilogues
    (csrc/fused_projection_v2.cu).
  - fused_projection_v2i: the same loop with the two D products in int8
    (csrc/fused_projection_v2i.cu); opt-in (`pallas_int8`).

Each wrapper runs its plain PyTorch version on CPU tensors and its kernel
on CUDA tensors. kernels/build.py compiles the sources with nvcc at first
use and holds the launch counters. The deep (v3) and 64x64 (v4) loops are
not ported yet (ROADMAP.md).
"""

from defensegan_torch.kernels.fused_projection_v2 import (
    dense_kernel_available, fused_projection_dense, make_dense_reconstructor,
    pack_dense)
from defensegan_torch.kernels.fused_projection_v2i import (
    fused_projection_dense_int8, make_dense_int8_reconstructor,
    pack_dense_int8)

__all__ = ["dense_kernel_available", "fused_projection_dense",
           "make_dense_reconstructor", "pack_dense",
           "fused_projection_dense_int8", "make_dense_int8_reconstructor",
           "pack_dense_int8"]
