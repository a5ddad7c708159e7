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
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from defensegan_torch.defense.fastgen import make_packed_apply, \
    pack_generator
from defensegan_torch.defense.project import (ReconstructionResult,
                                              rec_losses, sample_z0,
                                              select_restarts,
                                              tile_restarts)
from defensegan_torch.kernels import build
from defensegan_torch.kernels.gemm import split_k_for
from defensegan_torch.models.generator import from_image_space

ROW_TILE = 64        # rows are padded to, and chunks cut at, multiples of
                     # this (the kernels themselves take any row count)
COL_TILE = 64        # the kernel's k, F and P are multiples of this (a GEMM
                     # epilogue's warp covers 64 columns of a row)
SCRATCH_CAP = 1 << 30  # bytes of per-row scratch (h, do, dh) in one call
LIBRARY_ENTRY = {"fused_projection_v2": "fp_v2_run",
                 "fused_projection_v2i": "fp_v2i_run",
                 "fused_projection_v3": "fp_v3_run",
                 "fused_projection_v4": "fp_v4_run"}


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class DensePack(NamedTuple):
    w1: torch.Tensor    # [k, F] bf16 (BN folded)
    w1t: torch.Tensor   # [F, k] bf16
    b1: torch.Tensor    # [1, F] f32
    d: torch.Tensor     # [F, P] bf16 (output padded to P columns)
    dt: torch.Tensor    # [P, F] bf16
    bd: torch.Tensor    # [1, P] f32
    out_dim: int        # true (unpadded) output dim, e.g. 784
    z_dim: int


def pack_dense(generator, dtype: torch.dtype = torch.bfloat16) -> DensePack:
    """Dense-pack the frozen wide generator.

    dtype=bfloat16 is the kernel's pack, equal to the JAX package's
    (packed in the generator's compute dtype, then rounded to bf16) on
    the port's P columns; JAX's pack pads further with zero columns.
    dtype=float32 packs the same weights unrounded, for the fp32 plain
    path.
    """
    packed = pack_generator(generator, "dense",
                            dtype=torch.float32 if dtype == torch.float32
                            else None)
    d_mat, b_d = packed.dense
    out_dim = d_mat.shape[1]
    pad = _round_up(out_dim, COL_TILE) - out_dim
    d = F.pad(d_mat.float(), (0, pad))
    bd = F.pad(b_d.float(), (0, pad))
    w1 = packed.w_fc.float()
    return DensePack(
        w1=w1.to(dtype), w1t=w1.t().contiguous().to(dtype),
        b1=packed.b_fc.float()[None, :],
        d=d.to(dtype), dt=d.t().contiguous().to(dtype), bd=bd[None, :],
        out_dim=out_dim, z_dim=w1.shape[0])


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


def pad_to(t: torch.Tensor, dim: int, mult: int, value: float = 0.0):
    """Zero-pad (or `value`-pad) dim of t up to a multiple of mult."""
    extra = _round_up(t.shape[dim], mult) - t.shape[dim]
    if not extra:
        return t
    pads = [0, 0] * (t.ndim - dim - 1) + [0, extra]
    return F.pad(t, pads, value=value).contiguous()


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


def run_loop(name: str, x_pad: torch.Tensor, z0_flat: torch.Tensor,
             weights, scratch, dims: Sequence[int], *, out_dim: int,
             rec_iters: int, rec_lr: float, momentum: float,
             chunk: Optional[int] = None, entry: Optional[str] = None,
             counter: Optional[str] = None) -> torch.Tensor:
    """Drive a fused loop's library on CUDA tensors; z_final [N, k].

    Shared by the v2, v2i, v3 and v4 wrappers and the v3 variants (whose
    library holds three loops: `entry` names the one to call, `counter`
    its build.LAUNCHES key; both default to the library's own). Every
    library entry takes
    (z, v, x, *weights, *scratch, M, *dims, iters, lr, momentum, scale,
    stream). `weights`: the padded pack tensors in the library's argument
    order, W1 [kp, .] first; an entry that is no tensor (a host table of
    pointers or widths, as ctypes builds it) is handed on as it is.
    `scratch`: (columns, dtype) of each per-row
    scratch buffer, in argument order. `dims`: the kernel's widths, kp
    first. Rows are zero-padded up to a multiple of ROW_TILE and cropped
    after. They run in chunks of `chunk` rows, one library call (all L steps)
    each, counted in build.LAUNCHES[counter]; by default one chunk, unless
    its scratch would pass SCRATCH_CAP bytes.
    """
    w1 = weights[0]
    dev = z0_flat.device
    if dev.type != "cuda":
        raise ValueError(f"the fused kernel runs on CUDA tensors, got {dev}")
    tensors = [t for t in weights if isinstance(t, torch.Tensor)]
    if any(t.device != dev for t in tensors) or x_pad.device != dev:
        raise ValueError(f"pack on {w1.device}, x on {x_pad.device}, z0 on "
                         f"{dev}: all must be on one device")
    if w1.dtype != torch.bfloat16:
        raise ValueError("the fused kernel takes a bf16 pack")
    n, k = z0_flat.shape
    kp = w1.shape[0]
    rows = _round_up(n, ROW_TILE)
    if chunk is None:
        row_bytes = sum(cols * torch.empty(0, dtype=dt).element_size()
                        for cols, dt in scratch)
        chunk = max(ROW_TILE, SCRATCH_CAP // row_bytes // ROW_TILE * ROW_TILE)
    if chunk % ROW_TILE:
        raise ValueError(f"chunk={chunk} must be a multiple of {ROW_TILE}")
    m = min(chunk, rows)
    z = torch.zeros((rows, kp), dtype=torch.float32, device=dev)
    z[:n, :k] = z0_flat
    v = torch.zeros_like(z)
    x = pad_to(x_pad, 0, ROW_TILE).contiguous()
    bufs = [torch.empty((m, cols), dtype=dt, device=dev)
            for cols, dt in scratch]
    ptrs = [t.contiguous().data_ptr() if isinstance(t, torch.Tensor) else t
            for t in weights] + [t.data_ptr() for t in bufs]
    lib = build.load(name)
    fn = getattr(lib, entry or LIBRARY_ENTRY[name])
    fn.argtypes = [ctypes.c_void_p] * (3 + len(ptrs)) + \
        [ctypes.c_int] * (2 + len(dims)) + [ctypes.c_float] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # the library's host code (kernel attributes, SM count, the launch)
    # uses the runtime's current device: make it the tensors' device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo in range(0, rows, m):
            rc = fn(z[lo].data_ptr(), v[lo].data_ptr(), x[lo].data_ptr(),
                    *ptrs, min(m, rows - lo), *dims, rec_iters, rec_lr,
                    momentum, 2.0 / out_dim, stream)
            build.check(lib, rc, entry or name)
            build.LAUNCHES[counter or name] += 1
    return z[:n, :k]


def fused_projection_dense(pack: DensePack, x_flat_tanh: torch.Tensor,
                           z0_flat: torch.Tensor, *, rec_iters: int,
                           rec_lr: float, momentum: float,
                           chunk: Optional[int] = None) -> torch.Tensor:
    """Run the L-step loop for all N latents; returns z_final [N, k].

    x_flat_tanh: [N, out_dim] TANH-space images. z0_flat: [N, k] float32.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    x_pad = pad_targets(pack, x_flat_tanh, z0_flat.shape[0])
    if z0_flat.device.type == "cpu":
        return dense_loop_plain(pack, x_pad, z0_flat, rec_iters=rec_iters,
                                rec_lr=rec_lr, momentum=momentum)
    w1, w1t, b1 = padded_fc(pack)
    kp, fp = w1.shape
    splits = split_k_for(fp, kp)          # the fc backward dh @ W1^T
    bf16 = torch.bfloat16
    return run_loop(
        "fused_projection_v2", x_pad, z0_flat,
        [w1, w1t, b1, pad_to(pack.d, 0, COL_TILE),
         pad_to(pack.dt, 1, COL_TILE), pack.bd],
        [(kp, bf16), (fp, bf16), (pack.d.shape[1], bf16), (fp, bf16),
         (splits * kp, torch.float32)],
        (kp, fp, pack.d.shape[1], splits), out_dim=pack.out_dim,
        rec_iters=rec_iters, rec_lr=rec_lr, momentum=momentum, chunk=chunk)


def make_dense_reconstructor(generator, image_shape, *, rec_rr: int,
                             rec_iters: int, rec_lr: float, momentum: float,
                             loop: Optional[Callable] = None,
                             pack=None):
    """f(x, gen=None, z0=None) -> ReconstructionResult on the fused loop.

    loop/pack default to the bf16 v2 kernel and its pack (the int8 module
    passes its own). z0 ([B, R, k]) overrides sampling from the
    torch.Generator `gen`. Restart selection and G(z*) run outside the
    loop on the dense packed apply, so argmin semantics are those of
    defense/project.py.
    """
    if loop is None:
        loop, pack = fused_projection_dense, pack_dense(generator)
    apply_flat = make_packed_apply(pack_generator(generator, "dense"))
    z_dim = generator.latent_dim

    @torch.no_grad()
    def run(x: torch.Tensor, gen: Optional[torch.Generator] = None,
            z0: Optional[torch.Tensor] = None) -> ReconstructionResult:
        batch = x.shape[0]
        x_rep = tile_restarts(from_image_space(x).reshape(batch, -1), rec_rr)
        if z0 is None:
            z0 = sample_z0(gen, batch, rec_rr, z_dim, device=x.device)
        z_fin = loop(pack, x_rep, z0.reshape(batch * rec_rr, z_dim),
                     rec_iters=rec_iters, rec_lr=rec_lr, momentum=momentum)
        losses = rec_losses(apply_flat, z_fin, x_rep).reshape(batch, rec_rr)
        return select_restarts(losses, z_fin, apply_flat, image_shape)

    return run


def dense_kernel_available(generator) -> bool:
    """The dense kernels cover single-deconv (wide) generators up to the
    dense-packing bound (feat = base_hw^2 * channels[0] <= 16384)."""
    if len(generator.channels) != 1:
        return False
    return generator.base_hw ** 2 * generator.channels[0] <= 16384
