"""The stream64 probe: one fused deconv level of the 64x64 generator,
forward and input gradient, against the library's.

Port of scripts/stream64_probe.py. The question the JAX probe asked on a
TPU: can one fused block per deconv level, its activation never in device
memory, beat the compiler's own deconv pair by enough (>= 1.35x per level)
to justify a full fused 64x64 kernel, or not (<= 1.15x: close the
question)? The port asks it again on the H100, against cuDNN.

A level is a 5x5 stride-2 SAME transpose conv with its BatchNorm folded,
then relu, and the probe's workload is what the projection loop runs
through it per step: the forward plus the gradient to its input under a
fixed cotangent, x <- x - eta * d/dx[sum(relu(level(x)) * cot)]. Packed
phase-major (`pack_level`, on defense/fastgen.py::phase_decompose) the
level is a 3x3 SAME grid conv on the g x g input grid whose 4*co output
lanes hold the four output phases (p, q):

    h  = sum_k x[p+off_k] @ W_k + b          f32 until the relu test
    dh = bf16(cot * [h > 0])
    dx = sum_k bf16(dh[p-off_k] @ W_k^T)     each tap rounded, f32 sum

with taps k = (dy+1)*3 + (dx+1), off_k = dy*g + dx, a tap whose source
pixel leaves the grid contributing nothing. Taps a phase does not use stay
zero in W: the phase-major form issues 36/25 = 1.44x the level's
multiply-adds (less the border taps the CUDA kernel skips).

Layouts are the function's: x [N, g, g, ci] (NHWC), the cotangent
phase-blocked [N, g, g, 4*co] (`to_phase_blocked` of the standard
[N, 2g, 2g, co]), dx [N, g, g, ci] float32. `to_rows` / `from_rows` give
the TPU kernel's pixel-major tile rows, for comparing with it.

`fused_level` runs the level on a CUDA tensor through the hand-written
kernel (csrc/stream64_level.cu), on a CPU tensor through
`fused_level_plain`; `make_library_level` is the yardstick
(F.conv_transpose2d + bias + relu on cuDNN, the gradient by autograd),
which nothing on the kernel's path calls; `run_probe` checks the kernel
against it, then times the scan.
"""

from __future__ import annotations

import ctypes
import statistics
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from defensegan_torch.defense.fastgen import phase_decompose
from defensegan_torch.kernels import build
from defensegan_torch.kernels.fused_projection_v3 import (_bf16_round,
                                                          _tap_masks,
                                                          pixel_order)
from defensegan_torch.kernels.fused_projection_v4 import (grid_conv,
                                                          grid_conv_t)
from defensegan_torch.models.layers import (conv_transpose_pads,
                                            conv_transpose_same)
from defensegan_torch.ckpt.bridge import conv_transpose_weight

# celeba deep (dim=64) heavy levels: (base H, Cin, Cout)
LEVELS = {0: (4, 512, 256), 1: (8, 256, 128), 2: (16, 128, 64)}
# the JAX probe's images per kernel tile, by level
DEFAULT_TILE = {0: 128, 1: 64, 2: 32}
LIBRARY = "stream64_level"
COUNTER = "stream64_level"           # build.LAUNCHES key of this wrapper
NUMERICS_REL_MAX = 2e-2              # the JAX probe's bound against XLA
BUILD_MIN, CLOSE_MAX = 1.35, 1.15    # its pre-registered decision rule
ETA = 1e-3

# Published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


class LevelPack(NamedTuple):
    """A folded level packed for the kernel, on its device."""

    w: torch.Tensor      # [9*ci, 4*co] bf16, taps stacked on rows
    wt: torch.Tensor     # [9*4*co, ci] bf16, the per-tap transposes
    bias: torch.Tensor   # [4*co] f32
    masks: torch.Tensor  # [g*g, 9] f32 0/1: valid(pixel + off_k in grid)
    order: torch.Tensor  # [g*g] int32: the pixels, 9 taps first
    g: int
    ci: int
    co: int


def fold(w, b, scale, shift):
    """BatchNorm folded into the deconv: (w * scale, shift + b * scale),
    float32 numpy."""
    scale = np.asarray(scale, np.float32)
    return (np.asarray(w, np.float32) * scale,
            np.asarray(shift, np.float32) + np.asarray(b, np.float32) * scale)


def pack_level(w, b, scale, shift):
    """Fold BN into a [5, 5, ci, co] deconv kernel and pack it shift-major.

    Returns numpy (wcat [9, ci, 4*co], wcat_t [9, 4*co, ci], bias [4*co]):
    wcat[k][:, blk(p, q)] is the weight tap a base-grid pixel P reads from
    input pixel P + off_k when producing output phase (p, q); taps a phase
    does not use (the 2-tap rows of the 5-tap stride-2 window) stay zero.
    """
    w, b = fold(w, b, scale, shift)
    ci, co = w.shape[2], w.shape[3]
    pc = phase_decompose(w, b, to=np.asarray)
    wcat = np.zeros((9, ci, 4 * co), np.float32)
    for p in range(2):
        for q in range(2):
            kern = np.asarray(pc.kernels[p][q], np.float32)
            (ylo, _), (xlo, _) = pc.pads[p][q]
            for jy in range(kern.shape[0]):
                dy = jy - ylo
                for jx in range(kern.shape[1]):
                    dx = jx - xlo
                    assert abs(dy) <= 1 and abs(dx) <= 1, (dy, dx)
                    blk = (p * 2 + q) * co
                    wcat[(dy + 1) * 3 + dx + 1, :, blk:blk + co] = \
                        kern[jy, jx]
    wcat_t = np.transpose(wcat, (0, 2, 1)).copy()
    bias = np.tile(np.asarray(pc.bias, np.float32), 4)
    return wcat, wcat_t, bias


def level_tensors(wcat, wcat_t, bias, g: int, device) -> LevelPack:
    """The packed level on `device`, the weights rounded to bf16."""
    ci, co4 = wcat.shape[1], wcat.shape[2]
    bf = torch.bfloat16
    return LevelPack(
        w=torch.as_tensor(wcat.reshape(9 * ci, co4)).to(device, bf),
        wt=torch.as_tensor(wcat_t.reshape(9 * co4, ci)).to(device, bf),
        bias=torch.as_tensor(bias).to(device, torch.float32),
        masks=torch.from_numpy(_tap_masks(g)).to(device),
        order=torch.from_numpy(pixel_order(g)).to(device),
        g=g, ci=ci, co=co4 // 4)


def phase_perm(h: int, co: int) -> np.ndarray:
    """Row/col mapping: standard out[n, 2y+p, 2x+q, c] as a gather from the
    phase-blocked [n, h, h, 4*co] layout (for the numerics check)."""
    idx = np.zeros((2 * h, 2 * h, co, 3), np.int64)
    for oy in range(2 * h):
        for ox in range(2 * h):
            p, q = oy % 2, ox % 2
            idx[oy, ox, :, 0] = oy // 2
            idx[oy, ox, :, 1] = ox // 2
            idx[oy, ox, :, 2] = (p * 2 + q) * co + np.arange(co)
    return idx


def to_phase_blocked(cot: torch.Tensor) -> torch.Tensor:
    """Standard [N, 2g, 2g, co] -> phase-blocked [N, g, g, 4*co]: output
    pixel (2y+p, 2x+q) goes to base pixel (y, x), lanes (p*2+q)*co + c (the
    layout `phase_perm` maps)."""
    n, h2, _, co = cot.shape
    g = h2 // 2
    return cot.reshape(n, g, 2, g, 2, co).permute(0, 1, 3, 2, 4, 5) \
        .reshape(n, g, g, 4 * co)


def from_phase_blocked(blk: torch.Tensor) -> torch.Tensor:
    """The inverse of `to_phase_blocked`."""
    n, g, _, co4 = blk.shape
    co = co4 // 4
    return blk.reshape(n, g, g, 2, 2, co).permute(0, 1, 3, 2, 4, 5) \
        .reshape(n, 2 * g, 2 * g, co)


def _swap12(a):
    return a.permute(0, 2, 1, 3) if isinstance(a, torch.Tensor) \
        else a.transpose(0, 2, 1, 3)


def to_rows(x, tile: int):
    """[N, H, W, C] -> the TPU kernel's pixel-major rows [N*H*W, C] (row =
    pixel*T + t within each tile of T images). numpy or torch."""
    n, h, w, c = x.shape
    assert n % tile == 0
    return _swap12(x.reshape(n // tile, tile, h * w, c)).reshape(n * h * w, c)


def from_rows(r, n: int, h: int, tile: int):
    """The inverse of `to_rows` for an h x h grid."""
    c = r.shape[-1]
    return _swap12(r.reshape(n // tile, h * h, tile, c)).reshape(n, h, h, c)


def fused_level_plain(x: torch.Tensor, cot: torch.Tensor, pack: LevelPack,
                      return_dh: bool = False):
    """Plain PyTorch version of the level: the TPU kernel's body, its
    rounding points included (x and the weights bf16, h float32 until the
    relu test, dh bf16, each backward tap rounded to bf16, float32 sums).
    x: [N, g, g, ci], cot: [N, g, g, 4*co] phase-blocked; returns dx
    [N, g, g, ci] float32 (and dh [N, g, g, 4*co] bf16 with return_dh).
    On a CUDA device the caller turns TF32 off."""
    g, ci, co4 = pack.g, pack.ci, 4 * pack.co
    a = _bf16_round(x.float())
    h = grid_conv(a, pack.w.float().reshape(9, ci, co4), g) + pack.bias
    dh = torch.where(h > 0.0, cot.float(), 0.0).to(torch.bfloat16)
    dx = grid_conv_t(dh.float(), pack.wt.float().reshape(9, co4, ci), g)
    return (dx, dh) if return_dh else dx


def _check(x, cot, pack):
    n, g = x.shape[0], pack.g
    if tuple(x.shape) != (n, g, g, pack.ci) or \
            tuple(cot.shape) != (n, g, g, 4 * pack.co):
        raise ValueError(f"x {tuple(x.shape)} and cot {tuple(cot.shape)} are "
                         f"no level of (g, ci, co) = ({g}, {pack.ci}, "
                         f"{pack.co})")


def fused_level(x: torch.Tensor, cot: torch.Tensor, pack: LevelPack,
                return_dh: bool = False):
    """The level's forward and input gradient: dx [N, g, g, ci] float32
    (and dh [N, g, g, 4*co] bf16 with return_dh). A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel or raises. x in any
    float type (rounded to bf16, as the kernel reads it), cot bf16."""
    _check(x, cot, pack)
    if x.device.type == "cpu":
        return fused_level_plain(x, cot, pack, return_dh)
    dev, bf = x.device, torch.bfloat16
    if any(t.device != dev for t in (cot, pack.w, pack.wt, pack.bias)):
        raise ValueError(f"x, cot and the pack must all be on {dev}")
    if cot.dtype != bf or pack.w.dtype != bf or pack.wt.dtype != bf:
        raise ValueError("the level takes a bf16 cotangent and weights")
    n, g, ci, co4 = x.shape[0], pack.g, pack.ci, 4 * pack.co
    if ci % 64 or co4 % 64:
        raise ValueError(f"ci {ci} and 4*co {co4} must be multiples of 64")
    xb = x.to(bf).contiguous()
    cb = cot.contiguous()
    dh = torch.empty((n, g, g, co4), dtype=bf, device=dev)
    dx = torch.empty((n, g, g, ci), dtype=torch.float32, device=dev)
    lib = build.load(LIBRARY)
    fn = lib.fp_stream64_level
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):      # the library uses the current device
        rc = fn(xb.data_ptr(), cb.data_ptr(), pack.w.data_ptr(),
                pack.wt.data_ptr(), pack.bias.data_ptr(),
                pack.masks.data_ptr(), pack.order.data_ptr(),
                dh.data_ptr(), dx.data_ptr(), n, g, ci,
                co4, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "stream64_level")
    build.LAUNCHES[COUNTER] += 1
    return (dx, dh) if return_dh else dx


def check_against_plain(x: torch.Tensor, cot: torch.Tensor,
                        pack: LevelPack, dx: torch.Tensor,
                        dh: torch.Tensor) -> dict:
    """The kernel's dx and dh (`fused_level(..., return_dh=True)`) against
    the plain version on the same inputs, half by half.

    Forward: dh must equal the plain version's except where the relu test
    of h took the other side, which float32 summation order may do only
    where the plain h is within 1e-4 of the summed absolute products
    |x| @ |W_k| of 0 (two orders of such a sum differ by far less); each
    flip changes dh by a whole cot element, so dx is held on the kernel's
    own dh. Backward: dx against the plain backward of that dh within one
    bf16 ulp of the output plus one of every rounded tap
    (kernels/conv3x3.py::rounding_excess <= 0). max_abs_err: dx against
    the whole plain version, flips included. On a card the caller turns
    TF32 off.
    """
    from defensegan_torch.kernels.conv3x3 import rounding_excess
    n, g, ci, co4 = x.shape[0], pack.g, pack.ci, 4 * pack.co
    a = _bf16_round(x.float())
    wk = pack.w.float().reshape(9, ci, co4)
    h = grid_conv(a, wk, g) + pack.bias
    mag = grid_conv(a.abs(), wk.abs(), g)
    differ = dh != torch.where(h > 0.0, cot.float(), 0.0).to(torch.bfloat16)
    outside = differ & (h.abs() > 1e-4 * mag)
    ref = grid_conv_t(dh.float(), pack.wt.float().reshape(9, co4, ci), g)
    excess = rounding_excess(dx.reshape(n, -1), ref.reshape(n, -1),
                             dh.reshape(n, -1), pack.wt, g, "backward")
    plain = fused_level_plain(x, cot, pack)
    out = {"relu_flips": int(differ.sum()),
           "flips_outside_band": int(outside.sum()),
           "rounding_excess": excess,
           "max_abs_err": (dx - plain).abs().max().item(),
           "finite": bool(torch.isfinite(dx).all())}
    out["ok"] = out["flips_outside_band"] == 0 and excess <= 0 and \
        out["finite"]
    return out


def _library_weights(w, b, scale, shift, device):
    """The folded level as the library takes it: the transpose conv's
    weight [ci, co, 5, 5] rounded to bf16, the bias [1, co, 1, 1] f32."""
    wf, bf = fold(w, b, scale, shift)
    weight = torch.as_tensor(conv_transpose_weight(wf)).to(device,
                                                           torch.bfloat16)
    return weight, torch.as_tensor(bf).to(device).reshape(1, -1, 1, 1)


def make_library_level(w, b, scale, shift, cot: torch.Tensor):
    """The yardstick: the same folded level as one library call each way,
    f(x [N, g, g, ci]) -> dx float32. The forward is F.conv_transpose2d
    (cuDNN on a card) in bf16, then + bias and relu in float32; dx is
    autograd's gradient of sum(out * cot) (cot standard [N, 2g, 2g, co]).
    Nothing on the kernel's path calls it. It rounds the conv's output to
    bf16 before the relu test, where the kernel keeps h in float32."""
    weight, bias = _library_weights(w, b, scale, shift, cot.device)
    cot_nchw = cot.float().permute(0, 3, 1, 2)

    def grad(x: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            xv = x.detach().float().requires_grad_(True)
            y = conv_transpose_same(xv.permute(0, 3, 1, 2).to(torch.bfloat16),
                                    weight)
            out = torch.relu(y.float() + bias)
            return torch.autograd.grad((out * cot_nchw).sum(), xv)[0]

    return grad


def check_against_library(w, b, scale, shift, x: torch.Tensor,
                          cot: torch.Tensor, dx: torch.Tensor,
                          dh: torch.Tensor) -> dict:
    """The probe's numerics check: the kernel's dx (and dh, from
    `fused_level(..., return_dh=True)`) against the library's on the same
    folded weights and cotangent (cot standard [N, 2g, 2g, co]).

    The reference runs the library's transpose conv on the bf16-rounded
    operands with float32 sums and output (the function the JAX probe's
    XLA comparator computed on the TPU). The relu test is where two
    correct float32 sums of the same h may disagree, and each such flip
    moves dx by a whole cot * W term (at batch 512 up to 4% of max |dx|),
    so the check takes the test's two halves apart: the kernel's relu
    decisions may differ from the library's only where the library's h is
    within 1e-4 of its summed absolute products |x| * |W| of 0, and dx
    must be within NUMERICS_REL_MAX (2e-2, the JAX probe's bound) of its
    largest element from the library's gradient under the kernel's own
    dh. rel_err_own_relu: dx against the library's gradient under its own
    relu test, reported.
    """
    weight, bias = _library_weights(w, b, scale, shift, x.device)
    weight = weight.float()
    xb = x.detach().to(torch.bfloat16).float().permute(0, 3, 1, 2)
    cot_b = cot.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    dh_k = from_phase_blocked(dh.float()).permute(0, 3, 1, 2)
    with torch.enable_grad():
        xv = xb.clone().requires_grad_(True)
        y = conv_transpose_same(xv, weight)
        ref_k, = torch.autograd.grad(y, xv, dh_k, retain_graph=True)
        h = y.detach() + bias
        ref_own, = torch.autograd.grad(y, xv, torch.where(h > 0.0, cot_b,
                                                          0.0))
    mag = conv_transpose_same(xb.abs(), weight.abs())
    differ = torch.where(h > 0.0, cot_b, 0.0) != dh_k
    got = dx.float().permute(0, 3, 1, 2)

    def rel(ref):
        return ((got - ref).abs().max() / (ref.abs().max() + 1e-30)).item()
    out = {"rel_err": rel(ref_k), "rel_err_own_relu": rel(ref_own),
           "relu_flips": int(differ.sum()),
           "flips_outside_band": int((differ & (h.abs() > 1e-4 * mag))
                                     .sum())}
    out["numerics_ok"] = out["rel_err"] < NUMERICS_REL_MAX and \
        out["flips_outside_band"] == 0
    return out


def level_macs(level: int) -> int:
    """Multiply-adds of the level's transpose conv, one image, one
    direction: those that land inside the (2g) x (2g) output."""
    g, ci, co = LEVELS[level]
    lo, _ = conv_transpose_pads(5, 2)
    per_axis = sum(1 for i in range(g) for m in range(5)
                   if 0 <= lo + 2 * i - m < 2 * g)
    return per_axis * per_axis * ci * co


def level_bound(level: int, batch: int) -> dict:
    """Least time of one call at `batch` images on an H100 (published
    peaks): max(the level's multiply-adds forward and backward over the
    bf16 rate, x and cot read once and dx written once over HBM's)."""
    g, ci, co = LEVELS[level]
    t_ops = 2 * 2 * level_macs(level) * batch / PEAK_BF16
    weights = 2 * 9 * ci * 4 * co * 2 + 4 * co * 4
    t_bytes = (batch * g * g * (ci * 2 + 4 * co * 2 + ci * 4) + weights) \
        / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def draw_arrays(level: int, batch: int, seed: int = 0) -> dict:
    """The probe's weights and inputs from a seeded torch.Generator, as
    numpy (the JAX probe draws the same distributions from jax.random):
    w 0.1 N [5, 5, ci, co], b 0.1 N, the BatchNorm affine scale 1 + 0.1 N
    and shift 0.05 N, x0 N [batch, g, g, ci], cot N [batch, 2g, 2g, co]."""
    g, ci, co = LEVELS[level]
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).numpy()
    return dict(w=0.1 * randn(5, 5, ci, co), b=0.1 * randn(co),
                scale=1.0 + 0.1 * randn(co), shift=0.05 * randn(co),
                x0=randn(batch, g, g, ci), cot=randn(batch, 2 * g, 2 * g, co))


def resolve_device(device) -> torch.device:
    """The entry points run on the card unless asked for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return dev


def median_ms(fn, repeats: int, sync) -> float:
    """Median of `repeats` timed calls after one warm-up call, in ms."""
    fn()
    sync()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_probe(level: int, batch: int, tile: int, iters: int, repeats: int,
              *, device="cuda", seed: int = 0,
              arrays: Optional[dict] = None) -> dict:
    """The probe at one level: the numerics check of the kernel against
    the library on the same folded weights and cotangent
    (`check_against_library`), then the timed scans x <- x - eta * dx over
    `iters` steps (kernel, library in bf16 and plain version; median of
    `repeats` after a warm-up, per step).

    arrays: the numpy draws (`draw_arrays`' keys) to use instead of the
    seeded ones, e.g. the JAX probe's. tile: the JAX probe's images per
    TPU block, kept in the record; the CUDA kernel tiles 128 images by its
    own design, so the batch need only divide by it as on the TPU.
    """
    dev = resolve_device(device)
    g, ci, co = LEVELS[level]
    if batch % tile:
        raise ValueError(f"batch {batch} is not a multiple of tile {tile}")
    a = arrays if arrays is not None else draw_arrays(level, batch, seed)
    pack = level_tensors(*pack_level(a["w"], a["b"], a["scale"], a["shift"]),
                         g, dev)
    x0 = torch.as_tensor(np.asarray(a["x0"], np.float32)).to(dev)
    cot = torch.as_tensor(np.asarray(a["cot"], np.float32)).to(dev)
    cot_blk = to_phase_blocked(cot).to(torch.bfloat16)
    library = make_library_level(a["w"], a["b"], a["scale"], a["shift"], cot)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    dx, dh = fused_level(x0, cot_blk, pack, return_dh=True)
    numerics = check_against_library(a["w"], a["b"], a["scale"], a["shift"],
                                      x0, cot, dx, dh)
    del dx, dh

    def scan(step):
        def run():
            x = x0
            for _ in range(iters):
                x = x - ETA * step(x)
            return x
        return run

    times = {name: median_ms(scan(step), repeats, sync) / iters
             for name, step in (
                 ("kernel", lambda x: fused_level(x, cot_blk, pack)),
                 ("library", library),
                 ("plain", lambda x: fused_level_plain(x, cot_blk, pack)))}
    return {"metric": f"stream64_probe_L{level}", "batch": batch,
            "tile": tile, "iters": iters, "repeats": repeats, "g": g,
            "ci": ci, "co": co, "device": str(dev),
            "device_name": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu",
            **numerics,
            "kernel_ms_per_iter": times["kernel"],
            "library_ms_per_iter": times["library"],
            "plain_ms_per_iter": times["plain"],
            "speedup": times["library"] / times["kernel"],
            **level_bound(level, batch)}


def decision(speedups) -> dict:
    """Geomean of the per-level speedups against the library and the JAX
    probe's pre-registered rule: >= 1.35 build the full kernel, <= 1.15
    close the question, between: undecided."""
    geo = float(np.prod(speedups)) ** (1.0 / len(speedups))
    verdict = ("build the full kernel" if geo >= BUILD_MIN else
               "close the question" if geo <= CLOSE_MAX else "undecided")
    return {"geomean_speedup": geo, "build_min": BUILD_MIN,
            "close_max": CLOSE_MAX, "verdict": verdict}


def main(argv=None) -> list:
    import argparse
    import json
    import os
    from defensegan_torch.utils.misc import append_jsonl, ensure_dir
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--levels", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--tile", type=int, default=None,
                    help="the JAX probe's images per TPU block (default: "
                    "its per-level tiles 128 / 64 / 32); recorded, and the "
                    "batch must divide by it")
    ap.add_argument("--iters", type=int, default=50,
                    help="steps of each timed scan")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--results_dir", default="output/results_torch")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rows = []
    for lvl in args.levels:
        rec = run_probe(lvl, args.batch, args.tile or DEFAULT_TILE[lvl],
                        args.iters, args.repeats, device=args.device)
        print(json.dumps(rec), flush=True)
        rows.append(rec)
    ensure_dir(args.results_dir)
    for rec in rows:
        append_jsonl(os.path.join(args.results_dir, "stream64_probe.jsonl"),
                     rec)
    for rec in rows:
        print(f"L{rec['metric'][-1]}: kernel {rec['kernel_ms_per_iter']:.4f} "
              f"ms, library {rec['library_ms_per_iter']:.4f} ms per step: "
              f"speedup {rec['speedup']:.3f}", flush=True)
    d = decision([r["speedup"] for r in rows])
    print(f"geomean level speedup against the library: "
          f"{d['geomean_speedup']:.3f} (decision rule: >= {BUILD_MIN} build "
          f"the full kernel; <= {CLOSE_MAX} close the question): "
          f"{d['verdict']}", flush=True)
    if not all(r["numerics_ok"] for r in rows):
        raise SystemExit(1)
    return rows
