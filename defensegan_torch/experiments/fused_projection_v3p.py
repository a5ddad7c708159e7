"""Experiment v3p: the deep loop v3 on a padded 7 x 8 grid.

Port of scripts/fused_projection_v3p_exp.py, an experiment the JAX package
keeps as a record (on a TPU v5e it was slower than v3: RESULTS.md). The
function is v3's (kernels/fused_projection_v3.py) with ONE structural
change: the g x g = 7 x 7 pixel grid gets a zero pad COLUMN, 7 rows of
gx = 8 pixels, P = 56. With row = pixel, an x-edge tap of a 3x3 conv then
reads the pad column instead of wrapping into the next row, and a y-edge
tap reads outside [0, P): both are zero, so no tap needs a mask. The pad
pixels are kept at zero:

    h0 = relu(bf16(z @ W1) + b1)    zero blocks at pad pixels (b1_pad)
    h1 = relu(conv_A(h0) + ba) * padm                 one pad-mask multiply
    do = bf16((t - x)(1 - t^2) scale) * padm          one pad-mask multiply
    dh1, dh0: zero at pad pixels through the relu masks of h1 and h0

The fc rounds its product to bf16 before the bias (the TPU kernel's
per-pixel blocks): v3 rounds once, after the relu. That is v3p's one
rounding change; every other sum is v3's up to float32 order (a tap that
reads zeros adds nothing).

On the H100 the pad layout stays, but conv A issues only what can be
nonzero: a tap that reads only zeros would cost a whole slab of products,
while a tap mask costs the grid conv nothing. `padded_tap_masks` counts a
tap where its source is a real pixel (v3's taps: 361 a direction), and
`padded_pixel_order` walks only the 49 real pixels, so no pad pixel's
tile is issued. A skipped tap's products are exact zeros, so this is the
all-taps function bit for bit (`s2d_padded_loop_plain(counted_taps=
False)` keeps the all-taps form to show it).

`fused_projection_s2d_padded` takes v3's interface (x [N, 49*cb] in
s2d-flat order, z0 [N, k]) and pads the grid itself: on a CUDA tensor it
runs the hand-written kernel (csrc/fused_projection_v3_variants.cu,
fp_v3p_run), on a CPU tensor `s2d_padded_loop_plain`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from defensegan_torch.kernels.fused_projection_v3 import (
    S2DPack, check_targets, make_s2d_reconstructor, padded_s2d)
from defensegan_torch.kernels.gemm import split_k_for
from defensegan_torch.kernels.grid import bf16_round, tap_masks, tap_offsets
from defensegan_torch.kernels.loop import LoopState, run_loop

LIBRARY = "fused_projection_v3_variants"
COUNTER = "fused_projection_v3p"     # build.LAUNCHES key of this wrapper


def _pad_row_mask(gy: int, gx: int) -> np.ndarray:
    """[gy*gx, 1] 1.0 for real pixels (x < gx-1), 0.0 for the pad column."""
    m = np.ones((gy * gx, 1), np.float32)
    m[gx - 1::gx] = 0.0
    return m


def real_to_pad(g: int) -> np.ndarray:
    """[g*g] int64: each real pixel's index on the padded g x (g+1) grid."""
    return np.asarray([(p // g) * (g + 1) + p % g for p in range(g * g)],
                      np.int64)


def padded_tap_masks(g: int) -> np.ndarray:
    """[g*(g+1), 9] f32: tap k counts at padded pixel p where its source
    p + off_k (off_k = dy*(g+1) + dx) is a real pixel: in [0, g*(g+1)) and
    off the pad column. For a real pixel that is v3's mask at the same
    (y, x); the backward reads [p, 8 - k], the same test for p - off_k."""
    gx = g + 1
    m = np.zeros((g * gx, 9), np.float32)
    for p in range(g * gx):
        for k, (dy, dx) in enumerate(tap_offsets(g)):
            q = p + dy * gx + dx
            m[p, k] = float(0 <= q < g * gx and q % gx != g)
    return m


def padded_pixel_order(g: int) -> np.ndarray:
    """[g*g] int32: the real pixels' indices on the padded grid, most taps
    first as kernels/fused_projection_v3.py::pixel_order orders them (9
    inside, 6 on an edge, 4 in a corner; pixel order within a count): the
    grid conv's walk, which never reaches the pad column."""
    real = real_to_pad(g)
    return real[np.argsort(-tap_masks(g).sum(1), kind="stable")] \
        .astype(np.int32)


def pad_pixels(t: torch.Tensor, g: int, c: int) -> torch.Tensor:
    """[N, g*g*c] in (pixel, channel) order -> [N, g*(g+1)*c] on the padded
    grid, zero at the pad pixels."""
    n = t.shape[0]
    out = t.new_zeros((n, g * (g + 1), c))
    out[:, torch.from_numpy(real_to_pad(g)).to(t.device)] = \
        t.reshape(n, g * g, c)
    return out.reshape(n, -1)


def b1_pad(pack: S2DPack) -> torch.Tensor:
    """[g*(g+1), c0] f32: the fc bias per padded pixel, zero on the pad."""
    return pad_pixels(pack.b1.reshape(1, -1), pack.grid_hw,
                      pack.c0).reshape(-1, pack.c0)


def s2d_padded_loop_plain(pack: S2DPack, x_s2d: torch.Tensor,
                          z0: torch.Tensor, *, rec_iters: int, rec_lr: float,
                          momentum: float, round_fc: bool = True,
                          counted_taps: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the v3p loop; returns z_final [N, k].

    x_s2d: [N, 49*cb] tanh-space targets in s2d-flat order (v3's
    interface; padded here, rounded to bf16 as the kernel reads them).
    bf16 operands where the kernel rounds, float32 products; a tap is a
    shift of the padded pixel axis with zeros shifted in. As the kernel,
    conv A sums a tap only where `padded_tap_masks` counts it (both ways)
    and writes only the real pixels; counted_taps=False sums every tap at
    every pixel, the TPU kernel's form (the skipped taps read only zeros).
    Conv B's tap sum takes every in-range tap, as the kernel's
    tanh_grad_pack does. Takes a pack padded by `padded_s2d` as well. On
    a CUDA device the caller turns TF32 off. round_fc=False leaves out
    v3p's one rounding change (the fc product rounded before the bias):
    v3's function on the padded grid.
    """
    rnd = bf16_round
    g, c0, ca, cb = pack.grid_hw, pack.c0, pack.ca, pack.cb
    gx = g + 1
    npix = g * gx
    n = z0.shape[0]
    dev = z0.device
    offs = [dy * gx + dx for dy, dx in tap_offsets(g)]
    real = torch.from_numpy(real_to_pad(g)).to(dev)
    padm = torch.from_numpy(_pad_row_mask(g, gx)).to(dev)     # [P, 1]
    counts = torch.from_numpy(padded_tap_masks(g)).to(dev) > 0  # [P, 9]

    def mm(a, w):
        return (a @ w.float()).float()

    w1, w1t = pack.w1.float(), pack.w1t.float()
    ka = pack.ka.float().reshape(9, c0, ca)
    kat = pack.kat.float().reshape(9, ca, c0)
    kbp = pack.kbp.float()[:, :9 * cb]
    kbpt = pack.kbpt.float()[:9 * cb]
    b1 = b1_pad(pack)
    x = rnd(pad_pixels(x_s2d.float(), g, cb)).reshape(n, npix, cb)
    scale = 2.0 / (g * g * cb)

    def read(a, k, sign=1):
        """a[:, p + sign*off_k, :] per padded pixel p, zero outside
        [0, P): the TPU kernel's row shift with zeros shifted in."""
        s = sign * offs[k]
        ap = F.pad(a, (0, 0, gx + 1, gx + 1))
        return ap[:, gx + 1 + s:gx + 1 + s + npix]

    def tap_a(prod, k, sign=1):
        """One tap's term of conv A (sign -1: its backward, which reads
        masks[p, 8 - k]), dropped where the kernel does not issue it."""
        if not counted_taps:
            return prod
        kk = k if sign == 1 else 8 - k
        return torch.where(counts[:, kk, None], prod, 0.0)

    z = z0.float().clone()
    v = torch.zeros_like(z)
    for _ in range(rec_iters):
        fc = torch.zeros((n, npix, c0), device=dev)
        prod = mm(rnd(z), w1)
        fc[:, real] = (rnd(prod) if round_fc else prod).reshape(n, g * g, c0)
        h0 = torch.relu(fc + b1)
        h0b = rnd(h0)
        h1 = sum(tap_a(mm(read(h0b, k), ka[k]), k) for k in range(9))
        h1 = torch.relu(h1 + pack.ba) * padm
        obb = rnd(mm(rnd(h1), kbp))                      # [N, P, 9*cb]
        o = pack.bb + torch.zeros_like(x)
        for k in range(9):
            o = o + read(obb[:, :, k * cb:(k + 1) * cb], k)
        t = torch.tanh(o)
        do = rnd((t - x) * (1.0 - t * t) * scale) * padm
        dop = torch.cat([read(do, k, -1) for k in range(9)], dim=2)
        dh1 = rnd(torch.where(h1 > 0.0, mm(dop, kbpt), 0.0))
        dh0 = sum(tap_a(read(rnd(mm(dh1, kat[k])), k, -1), k, -1)
                  for k in range(9))
        dh0 = rnd(torch.where(h0 > 0.0, dh0, 0.0))
        v = momentum * v + mm(dh0[:, real].reshape(n, g * g * c0), w1t)
        z = z - rec_lr * v
    return z


def fused_projection_s2d_padded(pack: S2DPack, x_s2d: torch.Tensor,
                                z0_flat: torch.Tensor, *, rec_iters: int,
                                rec_lr: float, momentum: float,
                                chunk: Optional[int] = None) -> torch.Tensor:
    """Run the v3p loop for all N latents; returns z_final [N, k].

    v3's interface (kernels/fused_projection_v3.py::fused_projection_s2d):
    x_s2d [N, 49*cb] tanh-space targets in s2d-flat order, z0_flat [N, k].
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    check_targets(pack, x_s2d, z0_flat)
    if z0_flat.device.type == "cpu":
        return s2d_padded_loop_plain(pack, x_s2d, z0_flat,
                                     rec_iters=rec_iters, rec_lr=rec_lr,
                                     momentum=momentum)
    x_pad = pad_pixels(x_s2d.to(torch.bfloat16), pack.grid_hw, pack.cb)
    return run_loop(v3p_state(pack), x_pad, z0_flat, rec_iters=rec_iters,
                    rec_lr=rec_lr, momentum=momentum, chunk=chunk)


def v3p_state(pack: S2DPack) -> LoopState:
    """fp_v3p_run's state on the pack's device: the fc padded to the g x
    (g+1) grid, v3's other padded weights, v3p's tap masks, walk and pad
    mask; scratch per row on the padded grid. The targets go in padded
    (`pad_pixels`)."""
    g, dev, bf = pack.grid_hw, pack.w1.device, torch.bfloat16
    pp = padded_s2d(pack)
    kp, c0, ca, cb = pp.z_dim, pp.c0, pp.ca, pp.cb
    npix = g * (g + 1)
    npk, kpk = pp.kbp.shape[1], pp.kbpt.shape[0]
    w1 = pad_pixels(pp.w1, g, c0)                          # [kp, P*c0]
    w1t = pad_pixels(pp.w1t.t(), g, c0).t().contiguous()   # [P*c0, kp]
    b1 = b1_pad(pp).reshape(-1).contiguous()
    masks = torch.from_numpy(padded_tap_masks(g)).to(dev)
    order = torch.from_numpy(padded_pixel_order(g)).to(dev)
    padm = torch.from_numpy(_pad_row_mask(g, g + 1)).reshape(-1).to(dev)
    splits = split_k_for(npix * c0, kp)                    # the fc backward
    return LoopState(
        library=LIBRARY, entry="fp_v3p_run", counter=COUNTER,
        weights=(w1, w1t, b1, pp.ka, pp.kat, pp.ba, pp.kbp, pp.kbpt, pp.bb,
                 masks, order, padm),
        scratch=((kp, bf), (npix * c0, bf), (npix * ca, bf),
                 (npix * npk, bf), (npix * kpk, bf),
                 (splits * kp, torch.float32)),
        dims=(kp, c0, ca, cb, g, npk, kpk, splits), out_dim=g * g * pack.cb)


def make_s2d_padded_reconstructor(generator, image_shape, *, rec_rr: int,
                                  rec_iters: int, rec_lr: float,
                                  momentum: float):
    """f(x, gen=None, z0=None) -> ReconstructionResult on the v3p loop:
    v3's reconstructor (restart selection and G(z*) on the s2d packed
    apply) with only the in-loop layout changed."""
    return make_s2d_reconstructor(
        generator, image_shape, rec_rr=rec_rr, rec_iters=rec_iters,
        rec_lr=rec_lr, momentum=momentum, loop=fused_projection_s2d_padded)
