"""One 3x3 grid conv of the deep loops, on its own.

The grid convs of the v3 and v4 loops (csrc/conv3x3_sm90.cuh: wgmma + TMA
on Hopper) run inside the loops' libraries, many per step. `conv3x3`
launches one of them alone, through the v4 library's entry `fp_conv3x3`,
so that a test can hold the conv against a reference at each edge of its
design: the border taps of a small grid, the out level's 64 lanes, runs of
an interleave narrower than a tile, a row count that the 128-row tile does
not divide, the one-tile form of at most 64 rows (counted under
loop.ONE_TILE_COUNTER besides), and each way of summing the taps. On a
CPU tensor it runs `conv3x3_plain`, which rounds where the kernel rounds.

Layouts are the loops' own: an activation is [M, g*g*C], latent-major and
flat in (pixel, channel) order, in fine order where it is interleaved
(`interleave_perm`); weights are [9*cin, cout], taps stacked on rows.
Modes (the kernel's epilogues and tap sums):

    chain      out = bf16(relu(sum_k in[p + off_k] @ W_k + bias)), one chain
    per_tap    the same, each tap summed on its own, then added in float32
    tanh_grad  t = tanh(sum_k ... + bias);  out = bf16((t - x)(1 - t^2) scale)
    backward   out = bf16(sum_k bf16(in[p - off_k] @ W_k)) where h > 0, else
               0: the input gradient, masked by the relu of h (the
               activation it overwrites in the loops)
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from defensegan_torch.kernels import build
from defensegan_torch.kernels.fused_projection_v4 import (grid_conv,
                                                          grid_conv_t,
                                                          interleave_perm)
from defensegan_torch.kernels.grid import (bf16_round, pixel_order,
                                           tap_masks, tap_offsets)
from defensegan_torch.kernels.loop import ONE_TILE_COUNTER

MODES = {"chain": 0, "per_tap": 1, "tanh_grad": 2, "backward": 3}
LIBRARY = "fused_projection_v4"      # the library that holds fp_conv3x3
COUNTER = "conv3x3"                  # build.LAUNCHES key of this wrapper


def _perm(g: int, fine: int, device) -> torch.Tensor:
    return torch.from_numpy(interleave_perm(g, fine)).to(device)


def to_blocked(flat: torch.Tensor, g: int, fine: int) -> torch.Tensor:
    """[M, g*g*4*fine] rows in fine order -> blocked order (fine 0: as is)."""
    if not fine:
        return flat
    out = torch.empty_like(flat)
    out[:, _perm(g, fine, flat.device)] = flat
    return out


def to_fine(flat: torch.Tensor, g: int, fine: int) -> torch.Tensor:
    """[M, g*g*4*fine] rows in blocked order -> fine order (fine 0: as is)."""
    return flat[:, _perm(g, fine, flat.device)] if fine else flat


def _check(inp, w, g, mode, bias, x, h, in_fine, out_fine):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {sorted(MODES)}")
    cin, cout = w.shape[0] // 9, w.shape[1]
    if w.shape[0] != 9 * cin or inp.ndim != 2 or \
            inp.shape[1] != g * g * cin:
        raise ValueError(f"in {tuple(inp.shape)} and w {tuple(w.shape)} are "
                         f"no 3x3 conv on a {g}x{g} grid")
    out_shape = (inp.shape[0], g * g * cout)
    if mode == "backward":
        if h is None or tuple(h.shape) != out_shape or out_fine:
            raise ValueError("backward takes h [M, g*g*cout] in blocked "
                             "order")
    elif bias is None or bias.numel() != cout:
        raise ValueError(f"mode {mode!r} takes a bias of {cout}")
    if mode == "tanh_grad" and (x is None or tuple(x.shape) != out_shape
                                or out_fine):
        raise ValueError("tanh_grad takes x [M, g*g*cout] in blocked order")
    for fine, lanes in ((in_fine, cin), (out_fine, cout)):
        if fine and 4 * fine != lanes:
            raise ValueError(f"an interleave of {fine} lanes needs "
                             f"{4 * fine} channels, got {lanes}")


def conv3x3_plain(inp: torch.Tensor, w: torch.Tensor, g: int, mode: str, *,
                  bias: Optional[torch.Tensor] = None,
                  x: Optional[torch.Tensor] = None,
                  h: Optional[torch.Tensor] = None, scale: float = 1.0,
                  in_fine: int = 0, out_fine: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the conv: bf16 operands, float32 products,
    the bf16 roundings of the kernel (each tap's product in `backward`, the
    output in every mode). chain and per_tap differ only in the order of the
    kernel's float32 sums, so both run the taps one by one here."""
    _check(inp, w, g, mode, bias, x, h, in_fine, out_fine)
    m, cin, cout = inp.shape[0], w.shape[0] // 9, w.shape[1]
    a = to_blocked(bf16_round(inp.float()), g, in_fine).reshape(m, g, g, cin)
    wk = bf16_round(w.float()).reshape(9, cin, cout)
    if mode == "backward":
        acc = grid_conv_t(a, wk, g).reshape(m, -1)
        out = torch.where(h.float() > 0.0, acc, 0.0)
    else:
        acc = grid_conv(a, wk, g) + bias.float().reshape(-1)
        acc = acc.reshape(m, -1)
        if mode == "tanh_grad":
            t = torch.tanh(acc)
            out = (t - bf16_round(x.float())) * (1.0 - t * t) * scale
        else:
            out = torch.relu(acc)
    return to_fine(out.to(torch.bfloat16), g, out_fine)


def conv3x3(inp: torch.Tensor, w: torch.Tensor, g: int, mode: str, *,
            bias: Optional[torch.Tensor] = None,
            x: Optional[torch.Tensor] = None,
            h: Optional[torch.Tensor] = None, scale: float = 1.0,
            in_fine: int = 0, out_fine: int = 0) -> torch.Tensor:
    """One grid conv: the kernel on CUDA tensors (or raise), the plain
    version on CPU tensors. Returns a new [M, g*g*cout] bf16 tensor (fine
    order where out_fine); `backward` leaves h as it was."""
    kw = dict(bias=bias, x=x, h=h, scale=scale, in_fine=in_fine,
              out_fine=out_fine)
    if inp.device.type == "cpu":
        return conv3x3_plain(inp, w, g, mode, **kw)
    _check(inp, w, g, mode, bias, x, h, in_fine, out_fine)
    dev, bf = inp.device, torch.bfloat16
    if any(t is not None and (t.device != dev or not t.is_contiguous())
           for t in (w, bias, x, h)) or not inp.is_contiguous():
        raise ValueError(f"every tensor must be contiguous on {dev}")
    if any(t is not None and t.dtype != bf for t in (inp, w, x, h)):
        raise ValueError("the conv takes bf16 activations and weights")
    cin, cout = w.shape[0] // 9, w.shape[1]
    if cin % 64 or cout % 64:
        raise ValueError(f"cin {cin} and cout {cout} must be multiples of 64")
    m = inp.shape[0]
    out = h.clone() if mode == "backward" else torch.empty(
        (m, g * g * cout), dtype=bf, device=dev)
    masks = torch.from_numpy(tap_masks(g)).to(dev)
    order = torch.from_numpy(pixel_order(g)).to(dev)
    b = None if bias is None else bias.float().contiguous()
    lib = build.load(LIBRARY)
    fn = lib.fp_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tiles = build.one_tile_launches(lib)
    with torch.cuda.device(dev):      # the library uses the current device
        rc = fn(inp.data_ptr(), w.data_ptr(),
                None if b is None else b.data_ptr(), masks.data_ptr(),
                order.data_ptr(), None if x is None else x.data_ptr(),
                out.data_ptr(), m, g, cin, cout, in_fine, out_fine,
                MODES[mode], scale,
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "conv3x3")
    build.LAUNCHES[COUNTER] += 1
    if build.one_tile_launches(lib) > tiles:
        build.LAUNCHES[ONE_TILE_COUNTER] += 1
    return out


def _tap_magnitudes(a: torch.Tensor, w: torch.Tensor, g: int) -> torch.Tensor:
    """sum_k |a[p - off_k] @ W_k| on blocked [N, g, g, cin] (float32): the
    sizes of the backward's rounded taps, added up."""
    acc = 0.0
    for k, (dy, dx) in enumerate(tap_offsets(g)):
        t = F.pad((a @ w[k]).abs(), (0, 0, 1, 1, 1, 1))
        acc = acc + t[:, 1 - dy:1 - dy + g, 1 - dx:1 - dx + g]
    return acc


def rounding_excess(got: torch.Tensor, ref: torch.Tensor, inp: torch.Tensor,
                    w: torch.Tensor, g: int, mode: str, *, in_fine: int = 0,
                    out_fine: int = 0, scale: float = 1.0) -> float:
    """How far the kernel's output `got` leaves the rounding band around
    the plain version's `ref` on the same inputs: the largest excess of
    |got - ref| over the bound, element by element (<= 0: within it).

    Both round at the same points and differ only in the order of their
    float32 sums, which may flip a bf16 rounding. The bound: one bf16 ulp
    (2^-7) of the output and, in the backward, of every rounded tap (of the
    sum of their sizes), plus 1e-4 of the summed absolute products
    |in| @ |W_k| for the float32 sums themselves (two orders of such a sum
    differ by far less). A misplaced tap, slab, lane or row is off by
    partial sums of the products, far outside it. On a card the caller
    turns TF32 off.
    """
    m, cin, cout = inp.shape[0], w.shape[0] // 9, w.shape[1]
    a = bf16_round(to_blocked(inp, g, in_fine).float()).reshape(m, g, g, cin)
    wk = bf16_round(w.float()).reshape(9, cin, cout)
    backward = mode == "backward"
    k = wk.abs().reshape(3, 3, cin, cout)
    k = (k.flip(0, 1) if backward else k).permute(3, 2, 0, 1)
    mag = F.conv2d(a.abs().permute(0, 3, 1, 2), k, padding=1)
    band = 1e-4 * mag.permute(0, 2, 3, 1).reshape(m, -1)
    if backward:
        band = band + 2.0 ** -7 * _tap_magnitudes(a, wk, g).reshape(m, -1)
    got_b, ref_b = (to_blocked(t, g, out_fine).float() for t in (got, ref))
    bound = 2.0 ** -7 * ref_b.abs() + scale * band
    return ((got_b - ref_b).abs() - bound).max().item()
