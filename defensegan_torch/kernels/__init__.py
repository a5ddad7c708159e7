"""Hand-written CUDA kernels for the projection hot loop, and their wrappers.

  - fused_projection_v2: the wide single-deconv generator's L-step loop as
    four bf16 GEMM launches per step with fused epilogues
    (csrc/fused_projection_v2.cu).
  - fused_projection_v2i: the same loop with the two D products in int8
    (csrc/fused_projection_v2i.cu); opt-in (`pallas_int8`).
  - fused_projection_v3: the deep two-deconv generator's loop in
    space-to-depth form, 3x3 grid convs as per-tap tensor-core products
    (csrc/fused_projection_v3.cu).
  - fused_projection_v4: the multi-deconv generators' loop (the 64x64
    stacks), every deconv level a 3x3 grid conv, the interleaves folded
    into the convs' addressing (csrc/fused_projection_v4.cu); what
    `auto` runs on CUDA where neither v2 nor v3 covers the generator.
  - gemm, conv3x3: one product (csrc/gemm_sm90.cuh, under every product of
    the four loops) or one grid conv (csrc/conv3x3_sm90.cuh, under v3's and
    v4's convs) on its own, for holding it against its plain version.
  - loop: the layer under the four loops: each loop's kernel state
    (`LoopState`, built once per reconstructor), `run_loop`, which calls
    its library, and the reconstructor they share; grid: the grid
    convs' tap tables and padding.

Each wrapper runs its plain PyTorch version on CPU tensors and its kernel
on CUDA tensors. kernels/build.py compiles the sources with nvcc at first
use and holds the launch counters.
"""

from defensegan_torch.kernels.fused_projection_v2 import (
    dense_kernel_available, fused_projection_dense, make_dense_reconstructor,
    pack_dense)
from defensegan_torch.kernels.fused_projection_v2i import (
    fused_projection_dense_int8, make_dense_int8_reconstructor,
    pack_dense_int8)
from defensegan_torch.kernels.fused_projection_v3 import (
    fused_projection_s2d, make_s2d_reconstructor, pack_s2d,
    s2d_kernel_available)
# the v4 wrapper shares its module's name: import it from the module, so
# that `kernels.fused_projection_v4` stays the module
from defensegan_torch.kernels.fused_projection_v4 import (
    make_v4_reconstructor, pack_v4, v4_kernel_available)

__all__ = ["dense_kernel_available", "fused_projection_dense",
           "make_dense_reconstructor", "pack_dense",
           "fused_projection_dense_int8", "make_dense_int8_reconstructor",
           "pack_dense_int8", "fused_projection_s2d",
           "make_s2d_reconstructor", "pack_s2d", "s2d_kernel_available",
           "make_v4_reconstructor", "pack_v4",
           "v4_kernel_available"]
