"""Fused projection v2: the all-matmul wide-generator loop, bf16.

Port of the JAX package's kernels/fused_projection_v2.py. The flagship
wide arch (fc -> relu -> one stride-2 deconv -> tanh; configs/gans/
mnist_fast.yml) has a LINEAR deconv, materialized once as a dense matrix
D [F, P] (fastgen dense packing, output padded from 784 to P = 832 with
zero columns: a multiple of 64, which the CUDA GEMM's epilogue takes in
whole 64-column warp passes; the TPU pack pads to 896, its 128-lane
width). One projection step (reference
semantics: models/gan.py::reconstruct of kabkabm/defensegan) is then four
products plus elementwise work:

    h  = relu(z @ W1 + b1)            [N, F]    bf16 operands, f32 accum
    o  = h @ D + bD                   [N, P]
    t  = tanh(o);  r = t - x
    do = r * (1 - t^2) * (2/784)
    dh = (do @ D^T) * (h > 0)         [N, F]
    dz = dh @ W1^T                    [N, k]
    v  = m*v + dz;  z = z - lr*v

`fused_projection_dense` runs all L steps: on a CUDA tensor through the
hand-written kernel csrc/fused_projection_v2.cu (built by kernels/build.py),
on a CPU tensor through `dense_loop_plain`, its plain PyTorch version,
which rounds to bf16 where the kernel does and multiplies in float32. The
restart selection (losses of z_final, per-image argmin, G(z*)) runs
outside the loop through the dense packed apply, as in the JAX package.

D is the deconv unrolled, mostly zero blocks: the pack carries the slab
lists of D and D^T (kernels/gemm.py::slab_list), with which the kernel's
h @ D and do @ D^T walk only the K slabs of their nonzero blocks (182 of
686 and 142 of 637 on the flagship). The sums are the dense walk's; the
lists depend on the pack alone, never on the row count.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from defensegan_torch.defense.fastgen import make_packed_apply, \
    pack_generator
from defensegan_torch.kernels import build
from defensegan_torch.kernels.gemm import (TILE_M, SlabList, slab_list,
                                           split_k_for)
from defensegan_torch.kernels.loop import (COL_TILE, ROW_TILE, LoopState,
                                           default_chunk,
                                           make_loop_reconstructor, pad_to,
                                           round_up, run_loop)
from defensegan_torch.utils.profiling import span


class DensePack(NamedTuple):
    w1: torch.Tensor    # [k, F] bf16 (BN folded)
    w1t: torch.Tensor   # [F, k] bf16
    b1: torch.Tensor    # [1, F] f32
    d: torch.Tensor     # [F, P] bf16 (output padded to P columns)
    dt: torch.Tensor    # [P, F] bf16
    bd: torch.Tensor    # [1, P] f32
    out_dim: int        # true (unpadded) output dim, e.g. 784
    z_dim: int
    d_slabs: SlabList   # the K slabs of D each 128 columns of h @ D walk
    dt_slabs: SlabList  # the same of D^T for do @ D^T


def pack_dense(generator, dtype: torch.dtype = torch.bfloat16) -> DensePack:
    """Dense-pack the frozen wide generator.

    dtype=bfloat16 is the kernel's pack, equal to the JAX package's
    (packed in the generator's compute dtype, then rounded to bf16) on
    the port's P columns; JAX's pack pads further with zero columns.
    dtype=float32 packs the same weights unrounded, for the fp32 plain
    path. The slab lists are read from D and D^T as packed.
    """
    packed = pack_generator(generator, "dense",
                            dtype=torch.float32 if dtype == torch.float32
                            else None)
    d_mat, b_d = packed.dense
    out_dim = d_mat.shape[1]
    pad = round_up(out_dim, COL_TILE) - out_dim
    d = F.pad(d_mat.float(), (0, pad))
    bd = F.pad(b_d.float(), (0, pad))
    w1 = packed.w_fc.float()
    d, dt = d.to(dtype), d.t().contiguous().to(dtype)
    return DensePack(
        w1=w1.to(dtype), w1t=w1.t().contiguous().to(dtype),
        b1=packed.b_fc.float()[None, :], d=d, dt=dt, bd=bd[None, :],
        out_dim=out_dim, z_dim=w1.shape[0], d_slabs=slab_list(d),
        dt_slabs=slab_list(dt))


def rounding(pack: DensePack) -> Callable:
    """bf16 rounding of a float32 value for a bf16 pack, else identity."""
    if pack.w1.dtype == torch.bfloat16:
        return lambda a: a.to(torch.bfloat16).float()
    return lambda a: a


def dense_loop_plain(pack: DensePack, x_pad: torch.Tensor,
                     z0: torch.Tensor, *, rec_iters: int, rec_lr: float,
                     momentum: float) -> torch.Tensor:
    """Plain PyTorch version of the v2 loop; returns z_final [N, k].

    Operands are rounded to bf16 where the kernel rounds them and the
    products run in float32 (bf16 x bf16 with f32 accumulation). With a
    float32 pack nothing is rounded: the fp32 path. On a CUDA device the
    caller turns TF32 off for a float32 reference.
    """
    rnd = rounding(pack)
    w1, w1t, d, dt = (t.float() for t in (pack.w1, pack.w1t, pack.d,
                                          pack.dt))
    x = x_pad.float()
    scale = 2.0 / pack.out_dim
    z = z0.float().clone()
    v = torch.zeros_like(z)
    for _ in range(rec_iters):
        h = torch.relu(rnd(z) @ w1 + pack.b1)
        t = torch.tanh(rnd(h) @ d + pack.bd)
        do = rnd((t - x) * (1.0 - t * t) * scale)
        dh = rnd(torch.where(h > 0.0, do @ dt, 0.0))
        v = momentum * v + dh @ w1t
        z = z - rec_lr * v
    return z


def pad_targets(pack: DensePack, x_flat_tanh: torch.Tensor,
                n: int) -> torch.Tensor:
    """[N, out_dim] tanh-space targets -> [N, P] in the pack's dtype."""
    if tuple(x_flat_tanh.shape) != (n, pack.out_dim):
        raise ValueError(f"x {tuple(x_flat_tanh.shape)} vs [N, out_dim] = "
                         f"[{n}, {pack.out_dim}]")
    return F.pad(x_flat_tanh.to(pack.d.dtype),
                 (0, pack.d.shape[1] - pack.out_dim))


def padded_fc(pack: DensePack):
    """W1, W1^T and b1 with k and F up to multiples of the kernel's tile:
    zero rows and columns keep padded features at h = 0 and padded latents
    at z = 0."""
    return (pad_to(pad_to(pack.w1, 0, COL_TILE), 1, COL_TILE),
            pad_to(pad_to(pack.w1t, 0, COL_TILE), 1, COL_TILE),
            pad_to(pack.b1, 1, COL_TILE))


def dense_state(pack: DensePack) -> LoopState:
    """fp_v2_run's state: W1, W1^T, b1, D, D^T at the kernel's tiles, bD,
    the slab lists; scratch zb, h, do, dh, the fc backward's sums."""
    w1, w1t, b1 = padded_fc(pack)
    kp, fp = w1.shape
    p = pack.d.shape[1]
    splits = split_k_for(fp, kp)          # the fc backward dh @ W1^T
    bf16 = torch.bfloat16
    return LoopState(
        library="fused_projection_v2", entry="fp_v2_run",
        weights=(w1, w1t, b1, pad_to(pack.d, 0, COL_TILE),
                 pad_to(pack.dt, 1, COL_TILE), pack.bd, pack.d_slabs.off,
                 pack.d_slabs.idx, pack.dt_slabs.off, pack.dt_slabs.idx),
        scratch=((kp, bf16), (fp, bf16), (p, bf16), (fp, bf16),
                 (splits * kp, torch.float32)),
        dims=(kp, fp, p, splits), out_dim=pack.out_dim)


def fused_projection_dense(pack: DensePack, x_flat_tanh: torch.Tensor,
                           z0_flat: torch.Tensor, *, rec_iters: int,
                           rec_lr: float, momentum: float,
                           chunk: Optional[int] = None,
                           state: Optional[LoopState] = None
                           ) -> torch.Tensor:
    """Run the L-step loop for all N latents; returns z_final [N, k].

    x_flat_tanh: [N, out_dim] TANH-space images. z0_flat: [N, k] float32.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on `state` (`dense_state(pack)` when None) or raises.
    """
    x_pad = pad_targets(pack, x_flat_tanh, z0_flat.shape[0])
    if z0_flat.device.type == "cpu":
        with span("projection.loop"):
            return dense_loop_plain(pack, x_pad, z0_flat,
                                    rec_iters=rec_iters, rec_lr=rec_lr,
                                    momentum=momentum)
    state = state or dense_state(pack)
    chunk = chunk or default_chunk(state.scratch)
    z = run_loop(state, x_pad, z0_flat, rec_iters=rec_iters, rec_lr=rec_lr,
                 momentum=momentum, chunk=chunk)
    count_slabs(pack, z0_flat.shape[0], chunk, rec_iters)
    return z


def count_slabs(pack: DensePack, n: int, chunk: int, iters: int) -> None:
    """Add to build.SLABS what the library calls of one v2 run over n
    rows in chunks of `chunk` issue: per call, its 128-row M tiles x
    iters x the listed slabs (`.issued`) and every slab (`.dense`), for
    h @ D (`h@D`) and do @ D^T (`do@Dt`)."""
    rows = round_up(n, ROW_TILE)
    m_tiles = sum(-(-min(chunk, rows - lo) // TILE_M)
                  for lo in range(0, rows, chunk))
    for name, sl in (("h@D", pack.d_slabs), ("do@Dt", pack.dt_slabs)):
        build.SLABS[f"{name}.issued"] += m_tiles * iters * sl.issued
        build.SLABS[f"{name}.dense"] += m_tiles * iters * sl.dense


def make_dense_reconstructor(generator, image_shape, *, rec_rr: int,
                             rec_iters: int, rec_lr: float, momentum: float,
                             loop: Optional[Callable] = None,
                             pack=None):
    """f(x, gen=None, z0=None) -> ReconstructionResult on the fused loop
    (loop.py::make_loop_reconstructor), selecting on the dense packed
    apply. loop/pack default to v2, its state built here once (the int8
    module passes its own)."""
    if loop is None:
        pack = pack_dense(generator)
        loop = functools.partial(fused_projection_dense,
                                 state=dense_state(pack))
    return make_loop_reconstructor(
        functools.partial(loop, pack, rec_iters=rec_iters, rec_lr=rec_lr,
                          momentum=momentum),
        make_packed_apply(pack_generator(generator, "dense")),
        lambda x_tanh: (x_tanh.reshape(x_tanh.shape[0], -1), None),
        image_shape, rec_rr=rec_rr, z_dim=generator.latent_dim)


def dense_kernel_available(generator) -> bool:
    """The dense kernels cover single-deconv (wide) generators up to the
    dense-packing bound (feat = base_hw^2 * channels[0] <= 16384)."""
    if len(generator.channels) != 1:
        return False
    return generator.base_hw ** 2 * generator.channels[0] <= 16384
