"""Fused projection v3: the deep two-deconv generator's loop, bf16.

Port of the JAX package's kernels/fused_projection_v3.py. The
reference-depth topology (configs/gans/mnist.yml: z[128] -> fc -> 7x7x128
-> deconv 5x5/2 -> 14x14x64 -> deconv 5x5/2 -> 28x28x1 -> tanh; reference:
models/gan.py::generator_fn of kabkabm/defensegan) is packed in
SPACE-TO-DEPTH form (defense/fastgen.py variant="s2d"): both stride-2
deconvs become stride-1 3x3 SAME convs on the constant g x g = 7x7 grid
with wide channels (c0 128 -> ca 4*64 -> cb 16*1), the pixel un-shuffle is
a flat permutation outside the loop, and MSE is permutation-invariant, so
the loop never leaves s2d space. One projection step, per latent, taps
k = (dy+1)*3 + (dx+1) with pixel offset off_k = dy*g + dx:

    h0  = relu(bf16(z) @ w1 + b1)                       [49, c0]  -> bf16
    h1  = relu(sum_k h0[p+off_k] @ KA_k + ba)           [49, ca]  -> bf16
    obb = h1 @ [KB_0 .. KB_8]                           [49, 9*cb] -> bf16
    o   = bb + sum_k obb[p+off_k][k*cb:(k+1)*cb]        [49, cb]
    t   = tanh(o);  do = (t - x)(1 - t^2)(2/784)        [49, cb]  -> bf16
    dh1 = ([do[p-off_0] .. do[p-off_8]] @ KBT) * (h1>0) [49, ca]  -> bf16
    dh0 = (sum_k bf16(dh1[p-off_k] @ KA_k^T)) * (h0>0)  [49, c0]  -> bf16
    dz  = sum_p dh0[p] @ w1^T[p];  v = m*v + dz;  z = z - lr*v

(a tap whose source pixel leaves the grid contributes nothing).

Rounding points. The bf16 roundings at the layer boundaries (z, h0, h1,
do, dh1, dh0) are part of the function. The TPU kernel has two more, which
its layout forced: the packed conv-B product `obb` is rounded to bf16
before its nine tap slices are summed, and conv A's backward rounds each
tap's product to bf16 before the shifted sum. The port KEEPS both, in the
CUDA kernel and in the plain version alike: it then computes the reference
kernel's function up to float32 summation order, so the CPU test against
the Pallas kernel in interpret mode is as tight as v2's (1e-5 on z_final)
and shows any misplaced tap or mask; and the packed product goes through
device memory anyway, in bf16 at half the bytes of float32.

`fused_projection_s2d` runs all L steps: on a CUDA tensor through the
hand-written kernel csrc/fused_projection_v3.cu (built by kernels/build.py),
on a CPU tensor through `s2d_loop_plain`, its plain PyTorch version. Every
activation is kept latent-major and flat, [N, 49*C] in (pixel, channel)
order, exactly as the fc produces it; x is [N, 784] in s2d-flat order. The
restart selection (losses of z_final, per-image argmin, G(z*)) runs outside
the loop through the s2d packed apply, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from defensegan_torch.defense.fastgen import make_packed_apply, \
    pack_generator
from defensegan_torch.defense.project import (ReconstructionResult,
                                              rec_losses, sample_z0,
                                              select_restarts,
                                              tile_restarts)
from defensegan_torch.kernels.fused_projection_v2 import (COL_TILE, _round_up,
                                                          run_loop)
from defensegan_torch.kernels.gemm import split_k_for
from defensegan_torch.models.generator import from_image_space

SLAB = 32   # conv B's packed K (kpk) is padded to a multiple of this


class S2DPack(NamedTuple):
    """Dense tensors for the kernel, all derived from the s2d packing."""

    w1: torch.Tensor      # [k, 49*c0] bf16, fc (BN folded), flat (y, x, c)
    w1t: torch.Tensor     # [49*c0, k] bf16
    b1: torch.Tensor      # [49, c0] f32 (per-pixel rows of the folded bias)
    ka: torch.Tensor      # [9*c0, ca] bf16, conv A taps stacked on rows
    kat: torch.Tensor     # [9*ca, c0] bf16, per-tap transposes stacked
    ba: torch.Tensor      # [1, ca] f32
    kbp: torch.Tensor     # [ca, 9*cb] bf16, conv B taps packed on columns
    kbpt: torch.Tensor    # [9*cb, ca] bf16
    bb: torch.Tensor      # [1, cb] f32
    masks: torch.Tensor   # [49, 9] f32 0/1: valid(pixel + off_k in grid)
    c0: int               # fc channels (128)
    ca: int               # conv A output channels (256)
    cb: int               # conv B output channels (16)
    grid_hw: int          # 7
    z_dim: int


def _tap_offsets(g: int):
    """Pixel offsets of a 3x3 SAME conv, index k = (dy+1)*3 + (dx+1)."""
    return [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _tap_masks(g: int) -> np.ndarray:
    """[g*g, 9] validity of reading pixel p + off_k (inside the grid)."""
    m = np.zeros((g * g, 9), np.float32)
    for p in range(g * g):
        y, x = divmod(p, g)
        for k, (dy, dx) in enumerate(_tap_offsets(g)):
            m[p, k] = float(0 <= y + dy < g and 0 <= x + dx < g)
    return m


def pixel_order(g: int) -> np.ndarray:
    """[g*g] int32: the grid's pixels by their count of valid taps, most
    first (9 inside, 6 on an edge, 4 in a corner), in pixel order within a
    count. The grid conv (csrc/conv3x3_sm90.cuh) walks each 128-row slice
    of the activation in this order, so the cheapest tiles come last."""
    return np.argsort(-_tap_masks(g).sum(1), kind="stable").astype(np.int32)


def pack_s2d(generator) -> S2DPack:
    """Pack the frozen deep generator for the v3 kernel (equal to the JAX
    package's pack: s2d-packed in the generator's compute dtype, then
    rounded to bf16)."""
    packed = pack_generator(generator, "s2d")
    dev = packed.w_fc.device
    g = packed.base_hw
    (ka_, ba_, _), (kb_, bb_, _) = packed.convs      # [3, 3, ci, co] kernels
    ka_, kb_ = ka_.float(), kb_.float()
    c0, ca, cb = ka_.shape[2], ka_.shape[3], kb_.shape[3]
    taps = [(dy + 1, dx + 1) for dy, dx in _tap_offsets(g)]
    w1 = packed.w_fc.float()                          # [k, g*g*c0]
    bf = torch.bfloat16
    return S2DPack(
        w1=w1.to(bf), w1t=w1.t().contiguous().to(bf),
        b1=packed.b_fc.float().reshape(g * g, c0),
        ka=torch.cat([ka_[a, b] for a, b in taps], dim=0).to(bf),
        kat=torch.cat([ka_[a, b].t() for a, b in taps], dim=0).to(bf),
        ba=ba_.float()[None, :],
        kbp=torch.cat([kb_[a, b] for a, b in taps], dim=1).to(bf),
        kbpt=torch.cat([kb_[a, b].t() for a, b in taps], dim=0).to(bf),
        bb=bb_.float()[None, :],
        masks=torch.from_numpy(_tap_masks(g)).to(dev),
        c0=c0, ca=ca, cb=cb, grid_hw=g, z_dim=w1.shape[0])


def _bf16_round(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float()


def s2d_loop_plain(pack: S2DPack, x_s2d: torch.Tensor, z0: torch.Tensor, *,
                   rec_iters: int, rec_lr: float, momentum: float,
                   product_dtype: torch.dtype = torch.float32,
                   round_taps: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the v3 loop; returns z_final [N, k].

    x_s2d: [N, 49*cb] tanh-space targets in s2d-flat order (rounded to
    bf16 here, as the kernel reads them). Operands are rounded to bf16
    exactly where the CUDA kernel rounds them (module docstring) and the
    products run in float32. Takes a pack padded by `padded_s2d` as well
    (then z0 has the padded width). On a CUDA device the caller turns TF32
    off. product_dtype=float64 sums every product exactly and rounds the
    sum to float32: the control that shows how far two float32 summation
    orders of this loop drift apart on their own. round_taps=False: conv
    A's backward rounds once, after the sum of its taps (the tap-packed
    experiment, experiments/v3_packed.py).
    """
    rnd = _bf16_round
    tap = rnd if round_taps else (lambda a: a)
    g, c0, ca, cb = pack.grid_hw, pack.c0, pack.ca, pack.cb
    p2 = g * g
    n = z0.shape[0]
    offs = [dy * g + dx for dy, dx in _tap_offsets(g)]
    pd = product_dtype

    def mm(a, w):
        """a @ w summed in the product dtype, the sum rounded to f32."""
        return (a.to(pd) @ w).float()

    w1, w1t = pack.w1.to(pd), pack.w1t.to(pd)
    ka = pack.ka.to(pd).reshape(9, c0, ca)
    kat = pack.kat.to(pd).reshape(9, ca, c0)
    kbp = pack.kbp.to(pd)[:, :9 * cb]
    kbpt = pack.kbpt.to(pd)[:9 * cb]
    x = rnd(x_s2d).reshape(n, p2, cb)
    scale = 2.0 / (p2 * cb)

    def read(a, k, sign=1):
        """a[:, p + sign*off_k, :] per pixel p, zero where that pixel
        leaves the grid (p - off_k is p + off_{8-k})."""
        valid = pack.masks[:, k if sign > 0 else 8 - k]
        return torch.roll(a, -sign * offs[k], dims=1) * valid[None, :, None]

    z = z0.float().clone()
    v = torch.zeros_like(z)
    for _ in range(rec_iters):
        h0 = torch.relu(mm(rnd(z), w1).reshape(n, p2, c0) + pack.b1)
        h0b = rnd(h0)
        h1 = sum(mm(read(h0b, k), ka[k]) for k in range(9))
        h1 = torch.relu(h1 + pack.ba)
        obb = rnd(mm(rnd(h1), kbp))                      # [N, 49, 9*cb]
        o = pack.bb + torch.zeros_like(x)
        for k in range(9):
            o = o + read(obb[:, :, k * cb:(k + 1) * cb], k)
        t = torch.tanh(o)
        do = rnd((t - x) * (1.0 - t * t) * scale)
        dop = torch.cat([read(do, k, -1) for k in range(9)], dim=2)
        dh1 = rnd(torch.where(h1 > 0.0, mm(dop, kbpt), 0.0))
        dh0 = sum(read(tap(mm(dh1, kat[k])), k, -1) for k in range(9))
        dh0 = rnd(torch.where(h0 > 0.0, dh0, 0.0))
        v = momentum * v + mm(dh0.reshape(n, p2 * c0), w1t)
        z = z - rec_lr * v
    return z


def _pad_blocks(t: torch.Tensor, view, target) -> torch.Tensor:
    """View t as `view`, zero-pad every axis up to `target`."""
    pads = []
    for have, want in zip(reversed(view), reversed(target)):
        pads += [0, want - have]
    return F.pad(t.reshape(view), pads)


def padded_s2d(pack: S2DPack) -> S2DPack:
    """The pack at the kernel's tile widths: k, c0 and ca up to multiples
    of 64, the packed conv-B width 9*cb up to 64 on kbp's columns (the
    GEMM epilogue's 64-column passes) and up to 32 on kbpt's rows (its K:
    the GEMM would take any multiple of 8, 16 bytes a row; the pad keeps
    the packed layout of the first version). Zero
    rows and columns keep padded channels at h = 0 and padded latents at
    z = 0. The reference widths (128, 128, 256) need only the 9*cb pads.
    """
    p2 = pack.grid_hw ** 2
    k, c0, ca, nine_cb = pack.z_dim, pack.c0, pack.ca, 9 * pack.cb
    kp, c0p, cap = (_round_up(d, COL_TILE) for d in (k, c0, ca))
    npk, kpk = _round_up(nine_cb, COL_TILE), _round_up(nine_cb, SLAB)
    return pack._replace(
        w1=_pad_blocks(pack.w1, (k, p2, c0), (kp, p2, c0p)).reshape(kp, -1),
        w1t=_pad_blocks(pack.w1t, (p2, c0, k), (p2, c0p, kp)).reshape(-1, kp),
        b1=_pad_blocks(pack.b1, (p2, c0), (p2, c0p)),
        ka=_pad_blocks(pack.ka, (9, c0, ca), (9, c0p, cap)).reshape(-1, cap),
        kat=_pad_blocks(pack.kat, (9, ca, c0), (9, cap, c0p)).reshape(-1,
                                                                     c0p),
        ba=_pad_blocks(pack.ba, (1, ca), (1, cap)),
        kbp=_pad_blocks(pack.kbp, (ca, nine_cb), (cap, npk)),
        kbpt=_pad_blocks(pack.kbpt, (nine_cb, ca), (kpk, cap)),
        c0=c0p, ca=cap, z_dim=kp)


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def check_targets(pack: S2DPack, x_s2d: torch.Tensor,
                  z0_flat: torch.Tensor) -> None:
    """Raise unless x_s2d is [N, 49*cb] for the N rows of z0_flat."""
    n, out_dim = z0_flat.shape[0], pack.grid_hw ** 2 * pack.cb
    if tuple(x_s2d.shape) != (n, out_dim):
        raise ValueError(f"x {tuple(x_s2d.shape)} vs [N, out_dim] = "
                         f"[{n}, {out_dim}]")


def fused_projection_s2d(pack: S2DPack, x_s2d: torch.Tensor,
                         z0_flat: torch.Tensor, *, rec_iters: int,
                         rec_lr: float, momentum: float,
                         chunk: Optional[int] = None) -> torch.Tensor:
    """Run the L-step loop for all N latents; returns z_final [N, k].

    x_s2d: [N, 49*cb] TANH-space images in s2d-flat order (image-flat
    x[:, perm] of the s2d packing). z0_flat: [N, k] float32. A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel or raises.
    Rows are zero-padded to a multiple of 64 and cropped after.
    """
    check_targets(pack, x_s2d, z0_flat)
    if _on_cpu(z0_flat):
        return s2d_loop_plain(pack, x_s2d, z0_flat, rec_iters=rec_iters,
                              rec_lr=rec_lr, momentum=momentum)
    return run_s2d(pack, x_s2d, z0_flat, rec_iters=rec_iters, rec_lr=rec_lr,
                   momentum=momentum, chunk=chunk)


def run_s2d(pack: S2DPack, x_s2d: torch.Tensor, z0_flat: torch.Tensor, *,
            rec_iters: int, rec_lr: float, momentum: float,
            chunk: Optional[int] = None,
            library: str = "fused_projection_v3",
            entry: Optional[str] = None,
            counter: Optional[str] = None) -> torch.Tensor:
    """The loop on CUDA tensors through a library entry with fp_v3_run's
    arguments: v3's own, or one of the layout experiments that keep them
    (defensegan_torch/experiments/: `library`, `entry`, `counter` as in
    run_loop)."""
    p2 = pack.grid_hw ** 2
    pp = padded_s2d(pack)
    npk, kpk = pp.kbp.shape[1], pp.kbpt.shape[0]
    order = torch.from_numpy(pixel_order(pp.grid_hw)).to(z0_flat.device)
    bf = torch.bfloat16
    splits = split_k_for(p2 * pp.c0, pp.z_dim)    # the fc backward
    # dh1 and dh0 overwrite h1 and h0 in place (the kernel's epilogue
    # reads the relu mask and writes the gradient at the same index), so
    # the scratch is zb, h0, h1, the packed product, the packed do and the
    # fc backward's split sums
    return run_loop(
        library, x_s2d.to(bf), z0_flat,
        [pp.w1, pp.w1t, pp.b1, pp.ka, pp.kat, pp.ba, pp.kbp, pp.kbpt, pp.bb,
         pp.masks, order],
        [(pp.z_dim, bf), (p2 * pp.c0, bf), (p2 * pp.ca, bf), (p2 * npk, bf),
         (p2 * kpk, bf), (splits * pp.z_dim, torch.float32)],
        (pp.z_dim, pp.c0, pp.ca, pp.cb, pp.grid_hw, npk, kpk, splits),
        out_dim=p2 * pack.cb, rec_iters=rec_iters, rec_lr=rec_lr,
        momentum=momentum, chunk=chunk, entry=entry, counter=counter)


def make_s2d_reconstructor(generator, image_shape, *, rec_rr: int,
                           rec_iters: int, rec_lr: float, momentum: float,
                           loop=None):
    """f(x, gen=None, z0=None) -> ReconstructionResult on the fused s2d
    loop, for two-deconv deep generators.

    z0 ([B, R, k]) overrides sampling from the torch.Generator `gen`.
    Restart selection and G(z*) run outside the loop on the s2d packed
    apply (MSE is permutation-invariant), so argmin semantics are those of
    defense/project.py; x_hat is permuted back to image order. `loop`:
    another L loop with `fused_projection_s2d`'s signature (the layout
    experiments of defensegan_torch/experiments/), the same epilogue.
    """
    loop = loop or fused_projection_s2d
    pack = pack_s2d(generator)
    packed = pack_generator(generator, "s2d")
    apply_s2d = make_packed_apply(packed)             # flat s2d order
    perm, inv = packed.perm
    z_dim = generator.latent_dim

    @torch.no_grad()
    def run(x: torch.Tensor, gen: Optional[torch.Generator] = None,
            z0: Optional[torch.Tensor] = None) -> ReconstructionResult:
        batch = x.shape[0]
        x_s2d = from_image_space(x).reshape(batch, -1)[:, perm]
        x_rep = tile_restarts(x_s2d, rec_rr)
        if z0 is None:
            z0 = sample_z0(gen, batch, rec_rr, z_dim, device=x.device)
        z_fin = loop(
            pack, x_rep, z0.reshape(batch * rec_rr, z_dim),
            rec_iters=rec_iters, rec_lr=rec_lr, momentum=momentum)
        losses = rec_losses(apply_s2d, z_fin, x_rep).reshape(batch, rec_rr)
        res = select_restarts(losses, z_fin, apply_s2d)
        return res._replace(x_hat=res.x_hat[:, inv].reshape(
            (batch,) + tuple(image_shape)))

    return run


def s2d_kernel_available(generator) -> bool:
    """The v3 kernel covers two-deconv deep generators (e.g. MNIST
    7 -> 14 -> 28) up to channels[0] <= 256, the JAX package's bound."""
    return len(generator.channels) == 2 and generator.channels[0] <= 256
