"""Fused projection v4: the multi-deconv generators' loop, bf16.

Port of the JAX package's kernels/fused_projection_v4.py. It carries the
64x64 stacks (configs/gans/celeba.yml, celeba_wide.yml, imagenet64.yml;
reference: models/gan.py::generator_fn of kabkabm/defensegan at the CelebA
topology, z -> fc -> 4x4x512 -> three 5x5/2 deconv+BN+ReLU -> 32x32x64 ->
deconv -> 64x64x3 tanh) and, as its edge case, the two-deconv MNIST deep
topology. Every deconv becomes a 3x3 SAME conv on a grid, found by probing
the exact linear map (defense/fastgen.py::_probe_grid_conv):

  mid level   [g, g, ci] -> blocked [g, g, 4*co]: the stride-2 deconv
              followed by space-to-depth, + bias, relu. Every mid level but
              the last then INTERLEAVES its blocked output to the fine grid
              [2g, 2g, co], which is the next level's input.
  out level   blocked [g, g, 4*ci] -> double-blocked [g, g, 16*out_c]: the
              last interleave, the out deconv and two space-to-depths
              folded into one conv on the last mid level's grid; tanh and
              the loss gradient follow it.

MSE is permutation-invariant, so the targets are brought to double-blocked
order once (`x_rows`) and the loop never leaves blocked space. One step,
per latent, taps k = (dy+1)*3 + (dx+1):

    h0  = relu(bf16(z) @ w1 + b1)                            -> bf16
    a_i = sum_k h[p + off_k] @ W_i,k + b_i  (f32), relu      -> bf16
          (then interleaved where the level interleaves)
    t   = tanh(a_out) of the f32 sum;  d = (t - x)(1 - t^2)(2/out_dim)
                                                             -> bf16
    d_i = sum_k bf16(d[p - off_k] @ W_i,k^T), after the inverse interleave
          and the relu mask of a_i                           -> bf16
    dz  = (d_0 * [h0 > 0]) @ w1^T;  v = m*v + dz;  z = z - lr*v

The bf16 roundings are the TPU kernel's, the per-tap rounding of every
backward conv included, in the CUDA kernel and in the plain version alike:
both then compute the reference kernel's function up to float32 summation
order, and the CPU test against the Pallas kernel in interpret mode shows
any misplaced tap, lane or interleave.

`fused_projection_v4` runs all L steps: on a CUDA tensor through the
hand-written kernel csrc/fused_projection_v4.cu (built by kernels/build.py),
on a CPU tensor through `v4_loop_plain`. Activations are latent-major and
flat, [N, g*g*C] in (pixel, channel) order; an interleaved level is stored
directly in fine order (`interleave_perm` is the map, a permutation of
c-wide runs within a row), so the interleave is no pass of its own.

The TPU kernel's tile of latents and its `v4_tile_for` (a budget of on-chip
memory) have no meaning on the card and are left out: run_loop pads the
rows to a multiple of 64 and chunks them by its scratch cap. The restart
selection runs outside the loop through the conv-packed apply, in image
order, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from defensegan_torch.defense.fastgen import (_np, _probe_grid_conv, _s2d,
                                              _s2d_inv, make_packed_apply,
                                              pack_generator)
from defensegan_torch.kernels.gemm import split_k_for
from defensegan_torch.kernels.grid import (bf16_round, pad_blocks,
                                           pixel_order, tap_masks,
                                           tap_offsets)
from defensegan_torch.kernels.loop import (COL_TILE, LoopState,
                                           make_loop_reconstructor,
                                           round_up, run_loop)
from defensegan_torch.models.layers import conv_transpose_same
from defensegan_torch.utils.profiling import span

MAX_LEVELS = 4      # kMaxLevels of csrc/fused_projection_v4.cu


class V4Level(NamedTuple):
    """One grid conv of the chain, in execution order."""

    g: int                # grid height and width
    ci: int               # input lanes per grid pixel
    co: int               # output lanes per grid pixel (blocked)
    relu: bool            # False only for the out level
    interleave_after: Optional[int]   # fine lane count, or None
    w: torch.Tensor       # [9*ci, co] bf16, taps stacked on rows
    wt: torch.Tensor      # [9*co, ci] bf16, per-tap transposes stacked
    b: torch.Tensor       # [1, co] f32


class V4Pack(NamedTuple):
    w1: torch.Tensor      # [k, g0*g0*c0] bf16, fc (BN folded), flat (y, x, c)
    w1t: torch.Tensor     # [g0*g0*c0, k] bf16
    b1: torch.Tensor      # [g0*g0, c0] f32
    levels: Tuple[V4Level, ...]
    base_hw: int          # g0
    out_hw: int
    out_c: int
    z_dim: int
    c0: int
    out_dim: int          # out_hw * out_hw * out_c, the loss's mean

    @property
    def final_g(self) -> int:
        return self.levels[-1].g

    @property
    def out_lanes(self) -> int:
        return self.levels[-1].co


def v4_kernel_available(generator) -> bool:
    """v4 covers multi-deconv stacks up to the imagenet64-deep width
    (channels[0] <= 768), the JAX package's bound."""
    return len(generator.channels) >= 2 and generator.channels[0] <= 768


def interleave_perm(g: int, c: int) -> np.ndarray:
    """Gather indices of the interleave on flat rows: for a blocked
    activation [g*g, 4*c] (lanes (py, px, channel)) and its fine form
    [(2g)*(2g), c], fine_flat == blocked_flat[perm]. Blocked offset
    (y*g + x)*4c + (2*py + px)*c + j sits at fine offset
    ((2y + py)*2g + 2x + px)*c + j: the map the CUDA kernel stores and
    reads through (csrc/conv3x3_sm90.cuh::interleaved_offset)."""
    perm = np.empty(g * g * 4 * c, np.int64)
    j = np.arange(c)
    for y in range(g):
        for x in range(g):
            for py in range(2):
                for px in range(2):
                    blocked = (y * g + x) * 4 * c + (2 * py + px) * c
                    fine = ((2 * y + py) * 2 * g + 2 * x + px) * c
                    perm[fine + j] = blocked + j
    return perm


def pack_v4(generator) -> V4Pack:
    """Pack the frozen generator for the v4 kernel (equal to the JAX
    package's V4Pack: conv-packed in the generator's compute dtype, every
    level probed in float32, then rounded to bf16)."""
    packed = pack_generator(generator, "conv")
    convs = list(packed.convs)           # (weight [in, out, kh, kw], b, relu)
    if len(convs) < 2:
        raise ValueError("v4 covers multi-deconv stacks; the single-deconv "
                         "wide MNIST arch has the dense v2 kernel")
    dev = packed.w_fc.device
    g0, c0 = packed.base_hw, generator.channels[0]
    ksize = packed.kernel
    bf = torch.bfloat16
    w_fc = packed.w_fc.float()
    taps = [(dy + 1, dx + 1) for dy, dx in tap_offsets(g0)]
    levels = []
    grid = g0
    for i, (kern, bias, relu) in enumerate(convs):
        weight = torch.from_numpy(_np(kern))          # CPU f32, as probed
        bias = _np(bias)
        ci_im, co_im = weight.shape[0], weight.shape[1]
        last = i == len(convs) - 1
        if not last:
            def lin(x, weight=weight):
                y = conv_transpose_same(x.permute(0, 3, 1, 2), weight, ksize)
                return _s2d(y.permute(0, 2, 3, 1), 2)

            kgrid = _probe_grid_conv(lin, grid, ci_im)
            b_l = np.tile(bias, 4)
            # the last mid level does not interleave: the folded out level
            # reads its blocked output on the same grid
            inter = None if i == len(convs) - 2 else co_im
        else:
            def lin(xb, weight=weight, ci_im=ci_im):
                h = _s2d_inv(xb, 2, ci_im)
                y = conv_transpose_same(h.permute(0, 3, 1, 2), weight, ksize)
                return _s2d(_s2d(y.permute(0, 2, 3, 1), 2), 2)

            kgrid = _probe_grid_conv(lin, grid, 4 * ci_im)
            b_l = np.tile(bias, 16)
            inter = None
        kg = torch.from_numpy(kgrid)                  # [3, 3, ci, co]
        levels.append(V4Level(
            g=grid, ci=kg.shape[2], co=kg.shape[3], relu=bool(relu),
            interleave_after=inter,
            w=torch.cat([kg[a, b] for a, b in taps], dim=0).to(dev, bf),
            wt=torch.cat([kg[a, b].t() for a, b in taps], dim=0).to(dev, bf),
            b=torch.from_numpy(b_l[None, :].astype(np.float32)).to(dev)))
        if inter is not None:
            grid *= 2
    out_hw, out_c = generator.output_hw, generator.out_channels
    return V4Pack(
        w1=w_fc.to(bf), w1t=w_fc.t().contiguous().to(bf),
        b1=packed.b_fc.float().reshape(g0 * g0, c0), levels=tuple(levels),
        base_hw=g0, out_hw=out_hw, out_c=out_c, z_dim=w_fc.shape[0], c0=c0,
        out_dim=out_hw * out_hw * out_c)


def x_rows(pack: V4Pack, x_tanh: torch.Tensor) -> torch.Tensor:
    """[N, H, H, out_c] tanh-space images -> the loop's targets
    [N, final_g^2 * out_lanes], flat and latent-major: space-to-depth until
    the grid is the out level's (the JAX package's x_rows, without its
    regrouping of rows by tile)."""
    xb = x_tanh
    while xb.shape[1] > pack.final_g:
        xb = _s2d(xb, 2)
    return xb.reshape(xb.shape[0], -1)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w summed in w's dtype, the sum rounded to float32."""
    return (a.to(w.dtype) @ w).float()


def grid_conv(h: torch.Tensor, w: torch.Tensor, g: int) -> torch.Tensor:
    """out[p] = sum_k h[p + off_k] @ W_k on [N, g, g, ci] with w [9, ci, co]:
    each tap's product summed in w's dtype, the taps added in float32."""
    hp = F.pad(h, (0, 0, 1, 1, 1, 1))
    acc = 0.0
    for k, (dy, dx) in enumerate(tap_offsets(g)):
        acc = acc + _mm(hp[:, 1 + dy:1 + dy + g, 1 + dx:1 + dx + g], w[k])
    return acc


def grid_conv_t(d: torch.Tensor, wt: torch.Tensor, g: int) -> torch.Tensor:
    """out[p] = sum_k bf16(d @ W_k^T)[p - off_k] on [N, g, g, co] with wt
    [9, co, ci] (the per-tap transposes): each tap's product rounded before
    the float32 sum."""
    acc = 0.0
    for k, (dy, dx) in enumerate(tap_offsets(g)):
        t = F.pad(bf16_round(_mm(d, wt[k])), (0, 0, 1, 1, 1, 1))
        acc = acc + t[:, 1 - dy:1 - dy + g, 1 - dx:1 - dx + g]
    return acc


def v4_loop_plain(pack: V4Pack, x_flat: torch.Tensor, z0: torch.Tensor, *,
                  rec_iters: int, rec_lr: float, momentum: float,
                  product_dtype: torch.dtype = torch.float32
                  ) -> torch.Tensor:
    """Plain PyTorch version of the v4 loop; returns z_final [N, k].

    x_flat: [N, final_g^2 * out_lanes] tanh-space targets in double-blocked
    order (rounded to bf16 here, as the kernel reads them). Operands are
    rounded to bf16 exactly where the CUDA kernel rounds them (module
    docstring) and the products run in float32. Takes a pack padded by
    `padded_v4` as well (then x_flat and z0 have the padded widths). On a
    CUDA device the caller turns TF32 off. product_dtype=float64 sums every
    product exactly and rounds the sum to float32: the control that shows
    how far two float32 summation orders of this loop drift apart on their
    own.
    """
    rnd, pd = bf16_round, product_dtype
    n = z0.shape[0]
    g0, c0 = pack.base_hw, pack.c0

    w1, w1t = pack.w1.to(pd), pack.w1t.to(pd)
    weights = [(lv.w.to(pd).reshape(9, lv.ci, lv.co),
                lv.wt.to(pd).reshape(9, lv.co, lv.ci)) for lv in pack.levels]
    fg = pack.final_g
    x = rnd(x_flat.float()).reshape(n, fg, fg, pack.out_lanes)
    scale = 2.0 / pack.out_dim

    z = z0.float().clone()
    v = torch.zeros_like(z)
    for _ in range(rec_iters):
        h0 = torch.relu(_mm(rnd(z), w1).reshape(n, g0 * g0, c0) + pack.b1)
        acts = [h0.reshape(n, g0, g0, c0)]
        h = rnd(acts[0])
        for lv, (w, _) in zip(pack.levels, weights):
            a = grid_conv(h, w, lv.g) + lv.b
            if lv.relu:
                a = torch.relu(a)
            acts.append(a)
            h = rnd(a)
            if lv.interleave_after is not None:
                h = _s2d_inv(h, 2, lv.interleave_after)
        t = torch.tanh(acts[-1])
        d = rnd((t - x) * (1.0 - t * t) * scale)
        for i in range(len(pack.levels) - 1, -1, -1):
            lv = pack.levels[i]
            if lv.interleave_after is not None:
                d = _s2d(d, 2)
            if lv.relu:
                d = torch.where(acts[i + 1] > 0.0, d, 0.0)
            d = rnd(grid_conv_t(d, weights[i][1], lv.g))
        dh0 = rnd(torch.where(acts[0] > 0.0, d, 0.0))
        v = momentum * v + _mm(dh0.reshape(n, g0 * g0 * c0), w1t)
        z = z - rec_lr * v
    return z


def padded_v4(pack: V4Pack) -> V4Pack:
    """The pack at the kernel's tile widths: k, c0 and every interleaved
    level's fine channel count up to multiples of 64 (each of a blocked
    level's four runs is padded on its own, so a 64-wide tile never
    straddles two runs of an interleave), the last mid level's runs up to
    multiples of 16 (4 runs: whole tiles), the out level's 16*out_c lanes
    up to 64. Zero rows,
    columns and biases keep padded channels at 0, padded outputs at
    tanh(0) - 0 = 0 and padded latents at z = 0. The published widths
    (celeba, celeba_wide, imagenet64) need only the out level's pad.
    """
    p0 = pack.base_hw ** 2
    k, c0 = pack.z_dim, pack.c0
    kp, c0p = round_up(k, COL_TILE), round_up(c0, COL_TILE)
    levels = []
    cin, cinp = (c0,), (c0p,)          # the level's input lanes, as a view
    for lv in pack.levels:
        last = lv is pack.levels[-1]
        if last:
            cout, coutp = (lv.co,), (round_up(lv.co, COL_TILE),)
        else:
            # an interleaved run holds whole 64-wide tiles; the last mid
            # level's four runs only have to add up to such tiles
            cf = lv.co // 4
            mult = COL_TILE if lv.interleave_after is not None \
                else COL_TILE // 4
            cout, coutp = (4, cf), (4, round_up(cf, mult))
        ci_p, co_p = int(np.prod(cinp)), int(np.prod(coutp))
        inter = lv.interleave_after
        levels.append(lv._replace(
            ci=ci_p, co=co_p,
            interleave_after=None if inter is None else coutp[1],
            w=pad_blocks(lv.w, (9,) + cin + cout,
                         (9,) + cinp + coutp).reshape(9 * ci_p, co_p),
            wt=pad_blocks(lv.wt, (9,) + cout + cin,
                          (9,) + coutp + cinp).reshape(9 * co_p, ci_p),
            b=pad_blocks(lv.b, (1,) + cout, (1,) + coutp).reshape(1, co_p)))
        # an interleaved level hands its fine lanes on, the last mid level
        # its four blocked runs
        cin, cinp = ((cout[1],), (coutp[1],)) if inter is not None \
            else (cout, coutp)
    return pack._replace(
        w1=pad_blocks(pack.w1, (k, p0, c0), (kp, p0, c0p)).reshape(kp, -1),
        w1t=pad_blocks(pack.w1t, (p0, c0, k), (p0, c0p, kp)).reshape(-1, kp),
        b1=pad_blocks(pack.b1, (p0, c0), (p0, c0p)),
        levels=tuple(levels), z_dim=kp, c0=c0p)


def padded_targets(pack: V4Pack, x_flat: torch.Tensor) -> torch.Tensor:
    """[N, final_g^2 * out_lanes] targets -> bf16, zeros past the true
    lanes up to the padded out level's (`padded_v4`)."""
    n, p2 = x_flat.shape[0], pack.final_g ** 2
    return pad_blocks(x_flat.to(torch.bfloat16), (n, p2, pack.out_lanes),
                      (n, p2, round_up(pack.out_lanes, COL_TILE))
                      ).reshape(n, -1)


def _check_levels(pack: V4Pack) -> None:
    if not 2 <= len(pack.levels) <= MAX_LEVELS:
        raise ValueError(f"the v4 kernel takes 2 to {MAX_LEVELS} levels, "
                         f"got {len(pack.levels)}")


def v4_state(pack: V4Pack) -> LoopState:
    """fp_v4_run's state on the pack's device: the pack padded to the
    kernel's tiles, the levels' grid tables on the device, and the
    library's host tables of the level list: pointers (w, wt, b, masks,
    pixel order) and widths (g, ci, co, fine lanes of the interleave or
    0), which the library reads before each call returns."""
    _check_levels(pack)
    pp = padded_v4(pack)
    device = pp.w1.device
    grids = {lv.g: (torch.from_numpy(tap_masks(lv.g)).to(device),
                    torch.from_numpy(pixel_order(lv.g)).to(device))
             for lv in pp.levels}
    tensors = [t for lv in pp.levels
               for t in (lv.w, lv.wt, lv.b) + grids[lv.g]]
    if any(t.device != device or not t.is_contiguous() for t in tensors):
        raise ValueError(f"pack levels must be contiguous on {device}")
    ptr_table = (ctypes.c_void_p * len(tensors))(
        *[t.data_ptr() for t in tensors])
    dim_table = (ctypes.c_int * (4 * len(pp.levels)))(
        *[d for lv in pp.levels
          for d in (lv.g, lv.ci, lv.co, lv.interleave_after or 0)])
    bf = torch.bfloat16
    # one buffer holds h0 and every level's output side by side; gradients
    # overwrite the activations in place (a stored bf16 activation is its
    # own relu mask) and the out level's buffer holds d
    act_cols = pp.base_hw ** 2 * pp.c0 + sum(lv.g ** 2 * lv.co
                                             for lv in pp.levels)
    splits = split_k_for(pp.w1t.shape[0], pp.z_dim)   # the fc backward
    return LoopState(
        library="fused_projection_v4", entry="fp_v4_run",
        weights=(pp.w1, pp.w1t, pp.b1, ptr_table, dim_table),
        scratch=((pp.z_dim, bf), (act_cols, bf),
                 (splits * pp.z_dim, torch.float32)),
        dims=(pp.z_dim, pp.c0, pp.base_hw, len(pp.levels), splits),
        out_dim=pack.out_dim, keep=tuple(tensors))


def fused_projection_v4(pack: V4Pack, x_flat: torch.Tensor,
                        z0_flat: torch.Tensor, *, rec_iters: int,
                        rec_lr: float, momentum: float,
                        chunk: Optional[int] = None,
                        state: Optional[LoopState] = None) -> torch.Tensor:
    """Run the L-step loop for all N latents; returns z_final [N, k].

    x_flat: [N, out_dim] TANH-space images in double-blocked order
    (`x_rows`). z0_flat: [N, k] float32. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel on `state`
    (`v4_state(pack)` when None) or raises.
    """
    n = z0_flat.shape[0]
    if tuple(x_flat.shape) != (n, pack.final_g ** 2 * pack.out_lanes):
        raise ValueError(f"x {tuple(x_flat.shape)} vs [N, out_dim] = "
                         f"[{n}, {pack.final_g ** 2 * pack.out_lanes}]")
    _check_levels(pack)
    if z0_flat.device.type == "cpu":
        with span("projection.loop"):
            return v4_loop_plain(pack, x_flat, z0_flat, rec_iters=rec_iters,
                                 rec_lr=rec_lr, momentum=momentum)
    return run_loop(state or v4_state(pack), padded_targets(pack, x_flat),
                    z0_flat, rec_iters=rec_iters, rec_lr=rec_lr,
                    momentum=momentum, chunk=chunk)


def make_v4_reconstructor(generator, image_shape, *, rec_rr: int,
                          rec_iters: int, rec_lr: float, momentum: float):
    """f(x, gen=None, z0=None) -> ReconstructionResult on the fused v4
    loop (loop.py::make_loop_reconstructor), its state built here once:
    only the loop's targets are permuted (`x_rows`); the selection runs on
    the conv-packed apply in image order."""
    pack = pack_v4(generator)
    return make_loop_reconstructor(
        functools.partial(fused_projection_v4, pack, state=v4_state(pack),
                          rec_iters=rec_iters, rec_lr=rec_lr,
                          momentum=momentum),
        make_packed_apply(pack_generator(generator, "conv")),
        lambda x_tanh: (x_rows(pack, x_tanh),
                        x_tanh.reshape(x_tanh.shape[0], -1)),
        image_shape, rec_rr=rec_rr, z_dim=generator.latent_dim)
