"""Experiment: the deep loop v3 as two independent chains.

Port of scripts/pallas_v3_ilp_exp.py, an experiment the JAX package keeps
as a record (on a TPU v5e a tie with v3: RESULTS.md). The TPU kernel runs
v3's step on two independent 32-latent subtiles per grid step, so that
the compiler can overlap one subtile's vector stages with the other's
matrix products. On the H100 that lever lives inside a block of the grid
conv, which carries most of the step: a conv A tile is 128 latents, two
consumer warpgroups of 64 rows each, already two independent row chains.
The library's loop (csrc/fused_projection_v3_variants.cu, fp_v3_ilp_run)
runs v3's step with conv A, both ways, on the ping-pong schedule
(csrc/conv3x3_sm90.cuh, kPingPong): warpgroup 1 starts each tap once
warpgroup 0 has issued it (an ordered pair of named barriers per tap), so
the two run about a tap apart and one's fold and epilogue fall while the
other's products are queued; both read the same ring stages, so the L2
feed is v3's. Every output element sees v3's wgmma sequence: z_final
equals v3's bit for bit.

`fused_projection_ilp` runs the loop: on a CUDA tensor through the
kernel, on a CPU tensor through `ilp_loop_plain` (v3's plain loop on two
halves of the rows: the same function, rows being independent).
`conv_a` launches one conv A alone on either schedule, for holding the
ping-pong schedule against v3's and for measuring the conv's ceilings
(`probe`: the L2 feed alone, the products alone), its backward also with
the taps in one chain (packed's: no per-tap fold).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from defensegan_torch.kernels import build
from defensegan_torch.kernels.conv3x3 import conv3x3_plain
from defensegan_torch.kernels.fused_projection_v3 import (
    S2DPack, check_targets, fused_projection_s2d, make_s2d_reconstructor,
    s2d_loop_plain, s2d_state)
from defensegan_torch.kernels.grid import pixel_order, tap_masks, tap_offsets
from defensegan_torch.kernels.loop import ROW_TILE

LIBRARY = "fused_projection_v3_variants"
COUNTER = "fused_projection_v3_ilp"      # build.LAUNCHES key of this wrapper
CONV_COUNTER = "v3_conv_a"               # build.LAUNCHES key of `conv_a`
SCHEDULES = ("coop", "pingpong")         # v3's, ilp's
PROBES = ("whole", "feed", "math")       # the conv, the feed, the products
# conv A's modes: the forward (one chain), the backward with each tap
# rounded (v3's), and with the taps in one chain, rounded once (packed's)
CONV_A_MODES = ("chain", "backward", "backward_chain")
# fp_conv_a's parameters: in, w, bias, masks, order, out; M, g, cin, cout,
# backward, pingpong, probe; the stream
CONV_A_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + \
    [ctypes.c_void_p]


def halves(n: int) -> int:
    """Rows of the plain version's first chain: half of n rounded up to the
    64-row tile (n itself up to 64 rows: one chain)."""
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
    return fused_projection_s2d(
        pack, x_s2d, z0_flat, rec_iters=rec_iters, rec_lr=rec_lr,
        momentum=momentum, chunk=chunk,
        state=s2d_state(pack, library=LIBRARY,
                        entry="fp_v3_ilp_run")._replace(counter=COUNTER))


def conv_a(inp: torch.Tensor, w: torch.Tensor, g: int, mode: str, *,
           bias: Optional[torch.Tensor] = None,
           h: Optional[torch.Tensor] = None, schedule: str = "pingpong",
           probe: str = "whole") -> torch.Tensor:
    """One conv A launch of the loops alone, on v3's grid (masks and walk):
    mode "chain" (the forward: bf16(relu(sum of the taps + bias)), one
    chain) or "backward" (each tap rounded, masked by h > 0), as
    kernels/conv3x3.py's modes of those names, or "backward_chain" (the
    backward's taps in one chain, rounded once). On CUDA tensors it launches
    the grid conv on `schedule` ("coop": v3's, "pingpong": ilp's), or
    raises; `probe` "feed" keeps only the L2 feed (zeros stored), "math"
    only the products (the output undefined): timings, not convs. A CPU
    tensor runs conv3x3_plain (probe "whole" only; backward_chain: the
    taps' float32 sum, rounded once)."""
    if mode not in CONV_A_MODES:
        raise ValueError(f"conv A runs one of {CONV_A_MODES}, not {mode!r}")
    if schedule not in SCHEDULES or probe not in PROBES:
        raise ValueError(f"schedule {schedule!r} / probe {probe!r} not in "
                         f"{SCHEDULES} / {PROBES}")
    if inp.device.type == "cpu":
        if probe != "whole":
            raise ValueError("a probe launch runs on CUDA tensors only")
        if mode == "backward_chain":
            return _backward_chain_plain(inp, w, g, h)
        return conv3x3_plain(inp, w, g, mode, bias=bias, h=h)
    dev, bf = inp.device, torch.bfloat16
    cin, cout = w.shape[0] // 9, w.shape[1]
    backward = mode != "chain"
    if (backward and h is None) or (not backward and bias is None):
        raise ValueError("the forward takes a bias, the backward h")
    other = h if backward else bias
    if inp.shape[1] != g * g * cin or w.shape[0] != 9 * cin or \
            (backward and tuple(h.shape) != (inp.shape[0], g * g * cout)) \
            or (not backward and bias.numel() != cout):
        raise ValueError(f"in {tuple(inp.shape)}, w {tuple(w.shape)}: no "
                         f"conv A on a {g}x{g} grid")
    if any(t.device != dev or not t.is_contiguous()
           for t in (inp, w, other)):
        raise ValueError(f"every tensor must be contiguous on {dev}")
    if inp.dtype != bf or w.dtype != bf or (backward and h.dtype != bf):
        raise ValueError("conv A takes bf16 activations and weights")
    if cin % 64 or cout % 64:
        raise ValueError(f"cin {cin} and cout {cout} must be multiples of 64")
    m = inp.shape[0]
    out = h.clone() if backward else torch.empty(
        (m, g * g * cout), dtype=bf, device=dev)
    b = None if backward else bias.float().contiguous()
    masks = torch.from_numpy(tap_masks(g)).to(dev)
    order = torch.from_numpy(pixel_order(g)).to(dev)
    lib = build.load(LIBRARY)
    fn = lib.fp_conv_a
    fn.argtypes = CONV_A_ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):      # the library uses the current device
        rc = fn(inp.data_ptr(), w.data_ptr(),
                None if b is None else b.data_ptr(), masks.data_ptr(),
                order.data_ptr(), out.data_ptr(), m, g, cin, cout,
                CONV_A_MODES.index(mode), SCHEDULES.index(schedule),
                PROBES.index(probe),
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "conv_a")
    build.LAUNCHES[CONV_COUNTER] += 1
    return out


def _backward_chain_plain(inp: torch.Tensor, w: torch.Tensor, g: int,
                          h: torch.Tensor) -> torch.Tensor:
    """conv A's backward with its taps in one float32 sum, rounded once,
    masked by h > 0 (packed's; plain PyTorch)."""
    m, cin, cout = inp.shape[0], w.shape[0] // 9, w.shape[1]
    a = inp.float().reshape(m, g, g, cin)
    wk = w.float().reshape(9, cin, cout)
    acc = 0.0
    for k, (dy, dx) in enumerate(tap_offsets(g)):
        t = F.pad(a @ wk[k], (0, 0, 1, 1, 1, 1))
        acc = acc + t[:, 1 - dy:1 - dy + g, 1 - dx:1 - dx + g]
    out = torch.where(h.float() > 0.0, acc.reshape(m, -1), 0.0)
    return out.to(torch.bfloat16)


def make_ilp_reconstructor(generator, image_shape, *, rec_rr: int,
                           rec_iters: int, rec_lr: float, momentum: float):
    """f(x, gen=None, z0=None) -> ReconstructionResult on the two-chain
    loop: v3's reconstructor with only the loop changed."""
    return make_s2d_reconstructor(
        generator, image_shape, rec_rr=rec_rr, rec_iters=rec_iters,
        rec_lr=rec_lr, momentum=momentum, loop=fused_projection_ilp)
