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
and shows any misplaced tap or mask; and the three-launch form passes the
packed product through device memory, in bf16 at half the bytes of
float32.

`fused_projection_s2d` runs all L steps: on a CUDA tensor through the
hand-written kernel csrc/fused_projection_v3.cu (built by kernels/build.py),
on a CPU tensor through `s2d_loop_plain`, its plain PyTorch version. The
kernel's entry is chosen by the pack's shapes (`s2d_state`): conv B's
section as one fused kernel where it fits (cb 16, a grid of at most 64
pixels, ca up to 256: the deep MNIST generator), else as three launches;
both give one z_final, bit for bit. Every activation is kept latent-major
and flat, [N, 49*C] in (pixel, channel) order, exactly as the fc produces
it; x is [N, 784] in s2d-flat order. The restart selection (losses of
z_final, per-image argmin, G(z*)) runs outside the loop through the s2d
packed apply, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from defensegan_torch.defense.fastgen import make_packed_apply, \
    pack_generator
from defensegan_torch.kernels.gemm import split_k_for
from defensegan_torch.kernels.grid import (bf16_round, pad_blocks,
                                           pixel_order, tap_masks,
                                           tap_offsets)
from defensegan_torch.kernels.loop import (COL_TILE, LoopState,
                                           make_loop_reconstructor,
                                           round_up, run_loop)
from defensegan_torch.utils.profiling import span

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
    taps = [(dy + 1, dx + 1) for dy, dx in tap_offsets(g)]
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
        masks=torch.from_numpy(tap_masks(g)).to(dev),
        c0=c0, ca=ca, cb=cb, grid_hw=g, z_dim=w1.shape[0])


# Where v3's step may be cut (the sections of scripts/pallas_v3_diag2.py
# and of csrc/fused_projection_v3_step.cuh's `upto`), in step order
CUTS = ("fc", "convA", "convB", "grad", "convB_bwd", "convA_bwd", "full")


def s2d_step_plain(pack: S2DPack, x_s2d: torch.Tensor, z: torch.Tensor,
                   v: torch.Tensor, *, rec_lr: float, momentum: float,
                   product_dtype: torch.dtype = torch.float32,
                   round_taps: bool = True, round_obb: bool = True,
                   upto: str = "full", given: Optional[dict] = None):
    """One step of `s2d_loop_plain`; returns (z, v, sections).

    sections: each section's tensor up to the cut `upto` (CUTS), latent-
    major and flat [N, 49*C] in float32, as the kernel stores it: "fc" h0,
    "convA" h1 (both rounded to bf16), "convB" o (float32), "grad" do,
    "convB_bwd" dh1, "convA_bwd" dh0 (bf16), "full" the new v. A cut
    before "full" returns z and v as they were. `given` maps sections to
    tensors taken as they are instead of computed (a kernel's own, so
    that one section's arithmetic can be held alone). round_obb=False
    keeps conv B's packed product in float32 (v3 rounds it to bf16).
    """
    if upto not in CUTS:
        raise ValueError(f"upto={upto!r} is not one of {CUTS}")
    rnd = bf16_round
    tap = rnd if round_taps else (lambda a: a)
    obr = rnd if round_obb else (lambda a: a)
    g, c0, ca, cb = pack.grid_hw, pack.c0, pack.ca, pack.cb
    p2 = g * g
    n = z.shape[0]
    offs = [dy * g + dx for dy, dx in tap_offsets(g)]
    pd = product_dtype
    given = given or {}
    sections = {}

    def mm(a, w):
        """a @ w summed in the product dtype, the sum rounded to f32."""
        return (a.to(pd) @ w).float()

    def read(a, k, sign=1):
        """a[:, p + sign*off_k, :] per pixel p, zero where that pixel
        leaves the grid (p - off_k is p + off_{8-k})."""
        valid = pack.masks[:, k if sign > 0 else 8 - k]
        return torch.roll(a, -sign * offs[k], dims=1) * valid[None, :, None]

    def section(name, compute, store=lambda a: a):
        """The section's value: given, else computed; kept as stored."""
        t = given.get(name)
        val = compute() if t is None else t.float().reshape(n, p2, -1)
        sections[name] = store(val).reshape(n, -1)
        return val

    w1, w1t = pack.w1.to(pd), pack.w1t.to(pd)
    ka = pack.ka.to(pd).reshape(9, c0, ca)
    kat = pack.kat.to(pd).reshape(9, ca, c0)
    kbp = pack.kbp.to(pd)[:, :9 * cb]
    kbpt = pack.kbpt.to(pd)[:9 * cb]
    x = rnd(x_s2d).reshape(n, p2, cb)
    scale = 2.0 / (p2 * cb)

    h0 = section("fc", lambda: torch.relu(
        mm(rnd(z), w1).reshape(n, p2, c0) + pack.b1), rnd)
    if upto == "fc":
        return z, v, sections
    h0b = rnd(h0)
    h1 = section("convA", lambda: torch.relu(
        sum(mm(read(h0b, k), ka[k]) for k in range(9)) + pack.ba), rnd)
    if upto == "convA":
        return z, v, sections

    def conv_b():
        obb = obr(mm(rnd(h1), kbp))                      # [N, 49, 9*cb]
        o = pack.bb + torch.zeros_like(x)
        for k in range(9):
            o = o + read(obb[:, :, k * cb:(k + 1) * cb], k)
        return o

    o = section("convB", conv_b)
    if upto == "convB":
        return z, v, sections

    def grad():
        t = torch.tanh(o)
        return rnd((t - x) * (1.0 - t * t) * scale)

    do = section("grad", grad)
    if upto == "grad":
        return z, v, sections
    dop = torch.cat([read(do, k, -1) for k in range(9)], dim=2)
    dh1 = section("convB_bwd", lambda: rnd(
        torch.where(h1 > 0.0, mm(dop, kbpt), 0.0)))
    if upto == "convB_bwd":
        return z, v, sections
    dh0 = section("convA_bwd", lambda: rnd(torch.where(
        h0 > 0.0, sum(read(tap(mm(dh1, kat[k])), k, -1) for k in range(9)),
        0.0)))
    if upto == "convA_bwd":
        return z, v, sections
    v = momentum * v + mm(dh0.reshape(n, p2 * c0), w1t)
    z = z - rec_lr * v
    sections["full"] = v
    return z, v, sections


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
    experiment, experiments/v3_packed.py). One step is `s2d_step_plain`.
    """
    z = z0.float().clone()
    v = torch.zeros_like(z)
    for _ in range(rec_iters):
        z, v, _ = s2d_step_plain(pack, x_s2d, z, v, rec_lr=rec_lr,
                                 momentum=momentum,
                                 product_dtype=product_dtype,
                                 round_taps=round_taps)
    return z


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
    kp, c0p, cap = (round_up(d, COL_TILE) for d in (k, c0, ca))
    npk, kpk = round_up(nine_cb, COL_TILE), round_up(nine_cb, SLAB)
    return pack._replace(
        w1=pad_blocks(pack.w1, (k, p2, c0), (kp, p2, c0p)).reshape(kp, -1),
        w1t=pad_blocks(pack.w1t, (p2, c0, k), (p2, c0p, kp)).reshape(-1, kp),
        b1=pad_blocks(pack.b1, (p2, c0), (p2, c0p)),
        ka=pad_blocks(pack.ka, (9, c0, ca), (9, c0p, cap)).reshape(-1, cap),
        kat=pad_blocks(pack.kat, (9, ca, c0), (9, cap, c0p)).reshape(-1, c0p),
        ba=pad_blocks(pack.ba, (1, ca), (1, cap)),
        kbp=pad_blocks(pack.kbp, (ca, nine_cb), (cap, npk)),
        kbpt=pad_blocks(pack.kbpt, (nine_cb, ca), (kpk, cap)),
        c0=c0p, ca=cap, z_dim=kp)


def check_targets(pack: S2DPack, x_s2d: torch.Tensor,
                  z0_flat: torch.Tensor) -> None:
    """Raise unless x_s2d is [N, 49*cb] for the N rows of z0_flat."""
    n, out_dim = z0_flat.shape[0], pack.grid_hw ** 2 * pack.cb
    if tuple(x_s2d.shape) != (n, out_dim):
        raise ValueError(f"x {tuple(x_s2d.shape)} vs [N, out_dim] = "
                         f"[{n}, {out_dim}]")


LIBRARY = "fused_projection_v3"
ENTRY = "fp_v3_run"                # conv B's section as three launches
FUSED_ENTRY = "fp_v3_fused_run"    # conv B's section as one kernel
FUSED_COUNTER = "fused_projection_v3_fused"   # build.LAUNCHES key of its calls


def conv_b_fuses(pp: S2DPack) -> bool:
    """Whether the fused conv B section (csrc/fused_projection_v3_step.cuh,
    convb::section) takes the padded pack: cb 16 (one k16 step a tap), the
    grid in one 64-row wgmma tile, ca up to 256 (KBT and a ring of h1
    tiles in shared memory)."""
    return pp.cb == 16 and pp.grid_hw ** 2 <= 64 and pp.ca <= 256


def s2d_state(pack: S2DPack, *, library: str = LIBRARY,
              entry: Optional[str] = None,
              fused_conv_b: bool = False) -> LoopState:
    """The state of an entry with fp_v3_run's arguments (v3's, or a layout
    experiment's): the padded pack, tap masks, pixel order. entry None:
    v3's, by the pack's shapes: FUSED_ENTRY, counted under FUSED_COUNTER,
    where `conv_b_fuses`, else ENTRY. fused_conv_b: the entry runs conv
    B's section as one kernel and reads neither of its scratch buffers
    (packed product, packed do): none are allocated."""
    p2 = pack.grid_hw ** 2
    pp = padded_s2d(pack)
    counter = None
    if entry is None:
        fused_conv_b = conv_b_fuses(pp)
        entry, counter = (FUSED_ENTRY, FUSED_COUNTER) if fused_conv_b \
            else (ENTRY, None)
    npk, kpk = pp.kbp.shape[1], pp.kbpt.shape[0]
    order = torch.from_numpy(pixel_order(pp.grid_hw)).to(pp.w1.device)
    bf = torch.bfloat16
    splits = split_k_for(p2 * pp.c0, pp.z_dim)    # the fc backward
    # dh1 and dh0 overwrite h1 and h0 in place (the kernel's epilogue
    # reads the relu mask and writes the gradient at the same index), so
    # the scratch is zb, h0, h1, the packed product, the packed do and the
    # fc backward's split sums
    return LoopState(
        library=library, entry=entry,
        weights=(pp.w1, pp.w1t, pp.b1, pp.ka, pp.kat, pp.ba, pp.kbp,
                 pp.kbpt, pp.bb, pp.masks, order),
        scratch=((pp.z_dim, bf), (p2 * pp.c0, bf), (p2 * pp.ca, bf),
                 (0 if fused_conv_b else p2 * npk, bf),
                 (0 if fused_conv_b else p2 * kpk, bf),
                 (splits * pp.z_dim, torch.float32)),
        dims=(pp.z_dim, pp.c0, pp.ca, pp.cb, pp.grid_hw, npk, kpk, splits),
        out_dim=p2 * pack.cb, counter=counter)


def fused_projection_s2d(pack: S2DPack, x_s2d: torch.Tensor,
                         z0_flat: torch.Tensor, *, rec_iters: int,
                         rec_lr: float, momentum: float,
                         chunk: Optional[int] = None,
                         state: Optional[LoopState] = None) -> torch.Tensor:
    """Run the L-step loop for all N latents; returns z_final [N, k].

    x_s2d: [N, 49*cb] TANH-space images in s2d-flat order (image-flat
    x[:, perm] of the s2d packing). z0_flat: [N, k] float32. A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel on `state`
    (`s2d_state(pack)` when None; a layout experiment passes its own) or
    raises.
    """
    check_targets(pack, x_s2d, z0_flat)
    if z0_flat.device.type == "cpu":
        with span("projection.loop"):
            return s2d_loop_plain(pack, x_s2d, z0_flat, rec_iters=rec_iters,
                                  rec_lr=rec_lr, momentum=momentum)
    return run_loop(state or s2d_state(pack), x_s2d.to(torch.bfloat16),
                    z0_flat, rec_iters=rec_iters, rec_lr=rec_lr,
                    momentum=momentum, chunk=chunk)


def make_s2d_reconstructor(generator, image_shape, *, rec_rr: int,
                           rec_iters: int, rec_lr: float, momentum: float,
                           loop=None):
    """f(x, gen=None, z0=None) -> ReconstructionResult on the fused s2d
    loop (loop.py::make_loop_reconstructor), for two-deconv deep
    generators: targets and selection in s2d order (MSE is
    permutation-invariant), x_hat permuted back. `loop`: one with
    `fused_projection_s2d`'s signature (the layout experiments); by
    default v3's, its state built here once.
    """
    pack = pack_s2d(generator)
    loop = loop or functools.partial(fused_projection_s2d,
                                     state=s2d_state(pack))
    packed = pack_generator(generator, "s2d")
    perm, inv = packed.perm
    return make_loop_reconstructor(
        functools.partial(loop, pack, rec_iters=rec_iters, rec_lr=rec_lr,
                          momentum=momentum),
        make_packed_apply(packed),
        lambda x_tanh: (x_tanh.reshape(x_tanh.shape[0], -1)[:, perm], None),
        image_shape, rec_rr=rec_rr, z_dim=generator.latent_dim,
        unstage=lambda x_hat: x_hat[:, inv])


def s2d_kernel_available(generator) -> bool:
    """The v3 kernel covers two-deconv deep generators (e.g. MNIST
    7 -> 14 -> 28) up to channels[0] <= 256, the JAX package's bound."""
    return len(generator.channels) == 2 and generator.channels[0] <= 256
