"""One product of the fused loops, on its own.

Every product of the four projection loops (v2's and v2i's four, the fc
products of v3 and v4, v3's packed conv B in its three-launch form) runs
on one Hopper GEMM with a fused epilogue, csrc/gemm_sm90.cuh (wgmma +
TMA, persistent, warp-specialized), inside the loops' libraries. `gemm`
launches it alone, through the v2 library's entry `fp_gemm`, so that a
test can hold one product against `gemm_plain` at each edge of its
design: a K that the 128-byte slab does not divide (v2i's 832 in int8,
conv B's 160), an N of 6.5 tiles (P = 832), the split-K of the fc
backward (N = 128), rows that the 128-row tile does not divide. On a CPU
tensor it runs `gemm_plain`.

Operands: A [M, K] bf16 or int8. B [K, N] in bf16; in int8, B^T [N, K]
(K-major): 8-bit wgmma has no transpose flag for B, so the int8 pack keeps
K-major copies of its codes. Epilogues (the loops' own):

    store            C: f32 (bf16 products), int32 (int8)
    bias_relu        bf16(relu(C + bias))                   v2/v3/v4 fc
    bias_relu_amax   (relu(C + bias) f32, its row amax)     v2i fc
    tanh_grad        bf16((t - x)(1 - t^2) scale), t = tanh(C + bias)
    relu_mask        bf16(C) where h > 0, else 0            v2's do @ D^T
    momentum         v = m v + C; z = z - lr v; (z, v, bf16(z))
    tanh_grad_int8   (the tanh gradient of C (rs cs^T) + bias, f32, its
                     row amax)                              v2i's hq @ Dq
    relu_mask_int8   bf16(C (rs cs^T)) where h > 0          v2i's gq @ DTq

The fc backward's N = k = 128 is one tile wide, so its K is split into
fixed ranges (`split_k_for`, from K and N only: a row's sums then do not
depend on the call's row count) whose float32 sums one reduction adds.

A bf16 product whose B is mostly zero blocks (v2's D, the deconv
unrolled) takes a slab list (`slab_list`, built once from B): each N tile
walks only the K slabs whose block of B holds a nonzero. The blocks left
out are all zero, so the sums are the dense walk's.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from defensegan_torch.kernels import build

EPILOGUES = {"store": 0, "bias_relu": 1, "bias_relu_amax": 2,
             "tanh_grad": 3, "relu_mask": 4, "momentum": 5,
             "tanh_grad_int8": 6, "relu_mask_int8": 7}
INT8_EPILOGUES = ("store", "tanh_grad_int8", "relu_mask_int8")
LIBRARY = "fused_projection_v2"      # the library that holds fp_gemm
COUNTER = "gemm"                     # build.LAUNCHES key of this wrapper
TILE_M = 128          # rows of a tile (csrc/sm90_common.cuh kBM)
TILE_N = 128          # columns of a tile (csrc/gemm_sm90.cuh kGemmBN)
SLAB = 64             # bf16 of K per slab (128 bytes); int8 takes 128
SLABS_PER_SPLIT = 16  # K per split: 1024 bf16
MAX_SPLITS = 16


def split_k_for(K: int, N: int) -> int:
    """How many fixed K ranges a bf16 product splits into: one where N
    spans more than one tile, else one range per 16 slabs (1024 of K), at
    most 16. Depends on K and N only."""
    if N > TILE_N:
        return 1
    slabs = -(-K // SLAB)
    return min(MAX_SPLITS, -(-slabs // SLABS_PER_SPLIT))


def split_ranges(K: int, splits: int):
    """The K ranges [lo, hi) of the splits, as the kernel cuts them: whole
    slabs, ceil(slabs / splits) a split, the last one shorter."""
    slabs = -(-K // SLAB)
    per = -(-slabs // splits)
    return [(s * per * SLAB, min((s + 1) * per * SLAB, K))
            for s in range(splits)]


class SlabList(NamedTuple):
    """The K slabs each N tile of a product walks (csrc/gemm_sm90.cuh
    sm90::SlabList): tile j's are idx[off[j]:off[j + 1]], increasing."""
    off: torch.Tensor   # [N tiles + 1] int32
    idx: torch.Tensor   # [issued] int32
    issued: int         # blocks listed: the slabs one M tile walks
    dense: int          # N tiles x K slabs: what a dense walk issues


def slab_list(b: torch.Tensor) -> SlabList:
    """The slab list of a bf16 B [K, N], on B's device: for each TILE_N
    columns, the SLAB-deep K slabs whose block holds a nonzero entry of B
    itself (not of the geometry it came from), so that every block left
    out is an exact zero. Depends on B alone, never on M."""
    k, n = b.shape
    slabs, tiles = -(-k // SLAB), -(-n // TILE_N)
    nz = F.pad(b, (0, tiles * TILE_N - n, 0, slabs * SLAB - k)) != 0
    blocks = nz.reshape(slabs, SLAB, tiles, TILE_N).any(3).any(1).t()
    off = torch.zeros(tiles + 1, dtype=torch.int32, device=b.device)
    off[1:] = blocks.sum(1).cumsum(0)
    idx = blocks.nonzero()[:, 1].to(torch.int32)
    return SlabList(off=off, idx=idx.contiguous(), issued=idx.numel(),
                    dense=slabs * tiles)


def _dims(a, b):
    int8 = a.dtype == torch.int8
    m, k = a.shape
    n = b.shape[0] if int8 else b.shape[1]
    if (b.shape[1] if int8 else b.shape[0]) != k:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not "
                         "chain (int8 takes b as B^T [N, K])")
    return int8, m, n, k


def _check(a, b, epilogue, kw):
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue {epilogue!r} is not one of "
                         f"{sorted(EPILOGUES)}")
    if a.dtype not in (torch.bfloat16, torch.int8) or b.dtype != a.dtype:
        raise ValueError("the GEMM takes bf16 x bf16 or int8 x int8")
    int8, m, n, k = _dims(a, b)
    if epilogue != "store" and int8 != (epilogue in INT8_EPILOGUES):
        raise ValueError(f"epilogue {epilogue!r} does not take "
                         f"{a.dtype} operands")
    need = {"bias_relu": ("bias",), "bias_relu_amax": ("bias",),
            "tanh_grad": ("bias", "x"), "relu_mask": ("h",),
            "momentum": ("z", "v"),
            "tanh_grad_int8": ("bias", "x", "row_scale", "col_scale"),
            "relu_mask_int8": ("h", "row_scale", "col_scale")}
    for name in need.get(epilogue, ()):
        if kw.get(name) is None:
            raise ValueError(f"epilogue {epilogue!r} needs {name}")
    return int8, m, n, k


def _epilogue(acc, epilogue, *, bias=None, x=None, h=None, row_scale=None,
              col_scale=None, scale=1.0, z=None, v=None, lr=0.0,
              momentum=0.0):
    """The epilogue on float32 sums `acc` (exact sums for int8)."""
    bf = torch.bfloat16
    if epilogue in ("tanh_grad_int8", "relu_mask_int8"):
        acc = acc * (row_scale.float().reshape(-1, 1)
                     * col_scale.float().reshape(1, -1))
    if bias is not None:
        acc = acc + bias.float().reshape(1, -1)
    if epilogue == "bias_relu":
        return torch.relu(acc).to(bf)
    if epilogue == "bias_relu_amax":
        out = torch.relu(acc)
        return out, out.abs().amax(1)
    if epilogue in ("tanh_grad", "tanh_grad_int8"):
        t = torch.tanh(acc)
        out = (t - x.float()) * (1.0 - t * t) * scale
        return out.to(bf) if epilogue == "tanh_grad" else (out,
                                                           out.abs().amax(1))
    if epilogue in ("relu_mask", "relu_mask_int8"):
        return torch.where(h.float() > 0.0, acc, 0.0).to(bf)
    if epilogue == "momentum":
        v_new = momentum * v + acc
        z_new = z - lr * v_new
        return z_new, v_new, z_new.to(bf)
    return acc


def gemm_plain(a: torch.Tensor, b: torch.Tensor, epilogue: str = "store",
               **kw):
    """Plain PyTorch version of `gemm`: bf16 operands multiplied in float32
    (on a card the caller turns TF32 off), int8 products summed exactly (in
    float64, which holds every sum of K <= 2^37 products of +-127) and
    rounded to float32 as the kernel's int32 -> float conversion does;
    `store` of an int8 product returns the int32 sums."""
    int8, _, _, _ = _check(a, b, epilogue, kw)
    if int8:
        exact = a.double() @ b.double().t()
        if epilogue == "store":
            return exact.to(torch.int32)
        acc = exact.float()
    else:
        acc = a.float() @ b.float()
    return _epilogue(acc, epilogue, **kw)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def gemm(a: torch.Tensor, b: torch.Tensor, epilogue: str = "store", *,
         bias: Optional[torch.Tensor] = None,
         x: Optional[torch.Tensor] = None, h: Optional[torch.Tensor] = None,
         row_scale: Optional[torch.Tensor] = None,
         col_scale: Optional[torch.Tensor] = None, scale: float = 1.0,
         z: Optional[torch.Tensor] = None, v: Optional[torch.Tensor] = None,
         lr: float = 0.0, momentum: float = 0.0,
         slabs: Optional[SlabList] = None):
    """One product and its epilogue: the kernel on CUDA tensors (or raise),
    the plain version on CPU tensors. Returns new tensors (as
    `gemm_plain`); z and v are left as they were. A bf16 product splits K
    by `split_k_for`. `slabs` (`slab_list(b)`): the kernel walks only the
    listed slabs (bf16, K not split, epilogues store, tanh_grad and
    relu_mask: v2's D products); the plain version needs no list."""
    kw = dict(bias=bias, x=x, h=h, row_scale=row_scale, col_scale=col_scale,
              scale=scale, z=z, v=v, lr=lr, momentum=momentum)
    if a.device.type == "cpu":
        return gemm_plain(a, b, epilogue, **kw)
    int8, m, n, k = _check(a, b, epilogue, kw)
    if slabs is not None and (
            int8 or split_k_for(k, n) != 1
            or epilogue not in ("store", "tanh_grad", "relu_mask")):
        raise ValueError(f"a slab list takes a bf16 product of one K range "
                         f"with store, tanh_grad or relu_mask, not "
                         f"{a.dtype} K {k} N {n} {epilogue!r}")
    dev = a.device
    if slabs is not None and slabs.off.numel() != -(-n // TILE_N) + 1:
        raise ValueError(f"a slab list of {slabs.off.numel() - 1} tiles for "
                         f"N = {n}")
    tensors = (a, b, bias, x, h, row_scale, col_scale, z, v) + (
        () if slabs is None else (slabs.off, slabs.idx))
    if any(t is not None and (t.device != dev or not t.is_contiguous())
           for t in tensors):
        raise ValueError(f"every tensor must be contiguous on {dev}")
    if n % 64 or (k * a.element_size()) % 16:
        raise ValueError(f"the kernel takes N = {n} as a multiple of 64 and "
                         f"K = {k} rows as a multiple of 16 bytes")
    f32, bf = torch.float32, torch.bfloat16
    for name, t, dt in (("bias", bias, f32), ("row_scale", row_scale, f32),
                        ("col_scale", col_scale, f32), ("x", x, bf),
                        ("z", z, f32), ("v", v, f32),
                        ("h", h, f32 if epilogue == "relu_mask_int8"
                         else bf)):
        if t is not None and t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
    splits = 1 if int8 else split_k_for(k, n)
    amax = torch.zeros(m, dtype=torch.int32, device=dev)
    ws = torch.empty((m, splits * n), dtype=f32, device=dev) \
        if splits > 1 else None
    zc = vc = zb = None
    if epilogue == "store":
        out = torch.empty((m, n), dtype=torch.int32 if int8 else f32,
                          device=dev)
    elif epilogue in ("bias_relu_amax", "tanh_grad_int8"):
        out = torch.empty((m, n), dtype=f32, device=dev)
    elif epilogue == "momentum":
        out, zc, vc = None, z.clone(), v.clone()
        zb = torch.empty((m, n), dtype=bf, device=dev)
    else:
        out = torch.empty((m, n), dtype=bf, device=dev)
    lib = build.load(LIBRARY)
    fn = lib.fp_gemm
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + \
        [ctypes.c_float] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    off, idx = (None, None) if slabs is None else (slabs.off, slabs.idx)
    with torch.cuda.device(dev):      # the library uses the current device
        rc = fn(a.data_ptr(), b.data_ptr(), _ptr(out), _ptr(bias), _ptr(x),
                _ptr(h), _ptr(row_scale), _ptr(col_scale), amax.data_ptr(),
                _ptr(zc), _ptr(vc), _ptr(zb), _ptr(ws), _ptr(off), _ptr(idx),
                m, n, k, int(int8), splits, EPILOGUES[epilogue], scale, lr,
                momentum, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "gemm")
    build.LAUNCHES[COUNTER] += 1
    if epilogue == "momentum":
        return zc, vc, zb
    if epilogue in ("bias_relu_amax", "tanh_grad_int8"):
        return out, amax.view(f32)
    return out


def _as_tuple(t):
    return t if isinstance(t, tuple) else (t,)


def rounding_excess(got, ref, a: torch.Tensor, b: torch.Tensor,
                    epilogue: str, *, scale: float = 1.0,
                    lr: float = 0.0) -> float:
    """How far the kernel's outputs `got` leave the band around the plain
    version's `ref` on the same inputs: the largest excess of |got - ref|
    over the bound, element by element, over every output (<= 0: within).

    The two differ in the order of the float32 sums of a bf16 product
    (wgmma's chain, the K splits) and in float32 epilogue arithmetic
    (tanhf against torch.tanh); int8 sums are exact on both sides. The
    bound: one bf16 ulp (2^-7 relative) of an output stored in bf16, plus
    1e-4 of the summed absolute products |A| @ |B| times how far the
    epilogue stretches a change of the sum (1 for relu and the mask,
    5 * scale for the tanh gradient, lr for z), plus 1e-6 of the output
    and that stretch for the float32 epilogue itself. A misplaced slab,
    split, column or row is off by partial sums of the products, far
    outside it. On a card the caller turns TF32 off.
    """
    int8 = a.dtype == torch.int8
    if int8:
        mag = torch.zeros((a.shape[0], b.shape[0]), device=a.device)
    else:
        mag = 1e-4 * (a.float().abs() @ b.float().abs())
    stretch = {"tanh_grad": 5.0 * scale, "tanh_grad_int8": 5.0 * scale}.get(
        epilogue, 1.0)
    ulp = 2.0 ** -7
    if epilogue == "momentum":
        parts = [(lr, 0.0), (1.0, 0.0), (lr, ulp)]          # z, v, zb
    elif epilogue in ("bias_relu_amax", "tanh_grad_int8"):
        parts = [(stretch, 0.0), (stretch, 0.0)]            # f32 out, amax
    elif epilogue == "store":
        parts = [(1.0, 0.0)]
    else:
        parts = [(stretch, ulp)]
    worst = -float("inf")
    for (s, u), g, r in zip(parts, _as_tuple(got), _as_tuple(ref)):
        g, r = g.float(), r.float()
        band = mag if g.ndim == 2 else mag.amax(1)
        bound = u * r.abs() + s * band + 1e-6 * (r.abs() + s)
        if int8 and epilogue == "store":
            bound = torch.zeros_like(r)
        worst = max(worst, ((g - r).abs() - bound).max().item())
    return worst
