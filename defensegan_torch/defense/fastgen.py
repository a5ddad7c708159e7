"""Packed inference-time generators (port of defense/fastgen.py).

At inference the generator is a fixed chain z -> fc -> BN -> relu ->
[deconv -> BN -> relu]* -> deconv -> tanh, and every BatchNorm (running
averages) is an affine map folded into the adjacent weights once, at pack
time. Variants:

  variant="conv"   BN-folded weights, the deconvs stay transpose
                   convolutions.
  variant="phase"  each stride-2 deconv as 4 stride-1 sub-kernel
                   convolutions plus a pixel-shuffle interleave (no input
                   dilation).
  variant="dense"  (wide single-deconv arch only) the deconv is probed
                   with the identity basis into a dense [F, H*W*C] matrix,
                   so the generator is fc -> relu -> matmul -> tanh: the
                   form the fused projection kernels consume
                   (kernels/fused_projection_v2.py, _v2i.py).
  variant="hybrid" inner deconvs stay transpose convolutions; only the
                   FINAL deconv (1 or 3 output channels) is materialized
                   dense. Works for both archs.
  variant="s2d"    (two-deconv deep archs, e.g. MNIST 7->14->28) the whole
                   stack stays on the base grid in space-to-depth form:
                   each stride-2 deconv becomes a 3x3 stride-1 SAME conv
                   whose channels carry the sub-pixel phases (128 -> 4*64
                   -> 16*1 for MNIST deep), and the pixel un-shuffle is one
                   flat permutation applied OUTSIDE the hot loop. MSE is
                   permutation-invariant, so the projection loop runs
                   entirely in s2d space; this is the form the deep fused
                   kernel consumes (kernels/fused_projection_v3.py). The
                   kernels are built by probing the exact linear map, so
                   the zero-padding boundary behaviour carries over.

Packed applies return FLAT tanh images [N, H*W*C], float32, in NHWC pixel
order (variant="s2d": in space-to-depth order, see PackedGenerator.perm);
they compute in the generator's dtype and round where the JAX package's
packed apply rounds (after each product, bias add and tanh).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from defensegan_torch.models.generator import Generator
from defensegan_torch.models.layers import conv_transpose_pads, \
    conv_transpose_same

VARIANTS = ("conv", "phase", "dense", "hybrid", "s2d")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _bn_affine(params: dict, stats: dict, eps: float = 1e-5):
    """BatchNorm(running stats) == y = s*h + t per channel (numpy f32)."""
    s = np.asarray(params["scale"]) / np.sqrt(np.asarray(stats["var"]) + eps)
    t = np.asarray(params["bias"]) - s * np.asarray(stats["mean"])
    return s, t


def _bn_of(bn) -> Tuple[np.ndarray, np.ndarray]:
    return _bn_affine({"scale": _np(bn.scale), "bias": _np(bn.bias)},
                      {"mean": _np(bn.mean), "var": _np(bn.var)}, bn.eps)


class PhaseConv(NamedTuple):
    """One stride-2 deconv as 4 phase convs: out[2t+p, 2u+q] = phase[p][q].

    kernels[p][q]: [nh, nw, ci, co] (HWIO sub-kernel of the UNFLIPPED
    transpose-conv kernel, as the JAX package holds it); pads[p][q]:
    ((ylo, yhi), (xlo, xhi)); bias [co], added after the interleave.
    """

    kernels: Tuple[Tuple[torch.Tensor, ...], ...]
    pads: Tuple[Tuple[tuple, ...], ...]
    bias: torch.Tensor


def _hwio(kern: np.ndarray) -> np.ndarray:
    """The port's flipped [in, out, kh, kw] transpose-conv weight back to
    the unflipped HWIO kernel (inverse of ckpt/bridge.py's map)."""
    return np.ascontiguousarray(kern[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))


def _conv_nhwc(h: torch.Tensor, kern_hwio: torch.Tensor, pads) -> torch.Tensor:
    """Stride-1 cross-correlation of NHWC h with an HWIO kernel, zero
    padded ((ylo, yhi), (xlo, xhi)), in h's dtype."""
    (ylo, yhi), (xlo, xhi) = pads
    x = F.pad(h.permute(0, 3, 1, 2), (xlo, xhi, ylo, yhi))
    y = F.conv2d(x, kern_hwio.to(h.dtype).permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def phase_decompose(kernel: np.ndarray, bias: np.ndarray, stride: int = 2,
                    to=torch.as_tensor) -> PhaseConv:
    """Decompose a stride-2 SAME transpose-conv kernel (unflipped HWIO)
    into phase convs.

    For output phase p (rows) the contributing kernel taps m satisfy
    (p + m - pad_lo) even, hitting input offset a = (p + m - pad_lo)/2; the
    taps form a contiguous window, i.e. a plain stride-1 convolution.
    `to` places each numpy array (device and dtype).
    """
    k = kernel.shape[0]
    pad_lo, _ = conv_transpose_pads(k, stride)
    rows = []
    for p in range(stride):
        ms = [m for m in range(k) if (p + m - pad_lo) % stride == 0]
        a = [(p + m - pad_lo) // stride for m in ms]
        rows.append((ms, (-min(a), max(a))))
    kernels, pads = [], []
    for ms_y, pad_y in rows:
        kernels.append(tuple(to(np.ascontiguousarray(
            kernel[np.ix_(ms_y, ms_x)])) for ms_x, _ in rows))
        pads.append(tuple((pad_y, pad_x) for _, pad_x in rows))
    return PhaseConv(kernels=tuple(kernels), pads=tuple(pads), bias=to(bias))


def apply_phase_conv(pc: PhaseConv, h: torch.Tensor) -> torch.Tensor:
    """h [N, H, W, ci] -> [N, 2H, 2W, co], the SAME stride-2 transpose
    conv of h plus bias."""
    rows = [torch.stack([_conv_nhwc(h, pc.kernels[p][q], pc.pads[p][q])
                         for q in range(2)], dim=3)      # [N, H, W, 2, co]
            for p in range(2)]
    out = torch.stack(rows, dim=2)                       # [N, H, 2, W, 2, co]
    n, hh, _, ww, _, c = out.shape
    return out.reshape(n, 2 * hh, 2 * ww, c) + pc.bias


class PackedGenerator(NamedTuple):
    """BN-folded generator weights + static topology.

    convs, per deconv: variant "conv" / "hybrid" (inner deconvs): (weight
    [in, out, kh, kw] in the port's flipped transpose-conv layout, bias,
    relu_after); "phase": (PhaseConv, relu_after); "s2d": (kernel
    [3, 3, ci, co] HWIO of the stride-1 SAME grid conv, bias, relu_after).
    dense: (D [F, H*W*C], bD [H*W*C]) for "dense" and "hybrid".
    perm ("s2d" only): (perm, inv_perm) index tensors; img_flat[:, perm]
    is the s2d-ordered view and s2d_flat[:, inv_perm] restores image order.
    """

    variant: str
    base_hw: int
    out_hw: int
    out_channels: int
    w_fc: torch.Tensor            # [k, base_hw*base_hw*c0], BN folded
    b_fc: torch.Tensor            # [base_hw*base_hw*c0]
    convs: Tuple
    dense: Tuple
    dtype: torch.dtype
    kernel: int = 5
    perm: Tuple = ()


def _s2d(x: torch.Tensor, f: int) -> torch.Tensor:
    """[N, H, W, C] -> [N, H/f, W/f, f*f*C] space-to-depth (phase-major)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // f, f, w // f, f, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // f, w // f, f * f * c)


def _s2d_inv(x: torch.Tensor, f: int, c: int) -> torch.Tensor:
    """Inverse of _s2d: [N, g, g, f*f*C] -> [N, g*f, g*f, C]."""
    n, g, _, _ = x.shape
    x = x.reshape(n, g, g, f, f, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, g * f, g * f, c)


def _s2d_flat_perm(hw: int, f: int, c: int) -> np.ndarray:
    """Gather indices: img_flat[:, perm] == s2d_flat (both row-major)."""
    idx = torch.arange(hw * hw * c).reshape(1, hw, hw, c)
    return _s2d(idx, f).reshape(-1).numpy()


def _probe_grid_conv(lin_fn, g: int, cin: int, window: int = 3) -> np.ndarray:
    """Extract the [window, window, cin, cout] SAME-conv kernel of a linear,
    translation-equivariant (zero boundary) map on a [*, g, g, cin] grid.

    Probes with center deltas; raises if the response support does not fit
    the window (a wrong window size fails loudly instead of silently
    truncating).
    """
    y0 = g // 2
    r = window // 2
    basis = np.zeros((cin, g, g, cin), np.float32)
    basis[np.arange(cin), y0, y0, np.arange(cin)] = 1.0
    out = _np(lin_fn(torch.from_numpy(basis)))        # [cin, g, g, cout]
    mask = np.ones((g, g), bool)
    mask[y0 - r:y0 + r + 1, y0 - r:y0 + r + 1] = False
    spill = np.abs(out[:, mask, :]).max() if mask.any() else 0.0
    if spill > 0:
        raise ValueError(f"conv support exceeds window={window} "
                         f"(max spill {spill:.2e}); widen the window")
    kern = np.zeros((window, window, cin, out.shape[-1]), np.float32)
    for dy in range(window):
        for dx in range(window):
            kern[dy, dx] = out[:, y0 + r - dy, y0 + r - dx, :]
    return kern


def _dense_of(kern: np.ndarray, bias: np.ndarray, variant: str, out_hw: int,
              out_c: int, k: int):
    """The final (linear) deconv as a dense matrix (D [F, H*W*C], bD)."""
    in_hw, in_c = out_hw // 2, kern.shape[0]
    feat = in_hw * in_hw * in_c
    if feat > 16384:
        # the identity probe is O(feat^2) memory
        raise ValueError(
            f"variant={variant!r} materializes the final deconv as a dense "
            f"[{feat}, {4 * feat}] matrix — too large for this topology "
            f"(final-deconv input {in_hw}x{in_hw}x{in_c}); use 'conv' (or "
            "'s2d'/'phase')")
    # identity probe through the same transpose conv: each output is one
    # kernel tap times 1.0, so the matrix is exact in float32
    eye = torch.eye(feat).reshape(feat, in_hw, in_hw, in_c)
    cols = conv_transpose_same(eye.permute(0, 3, 1, 2), torch.as_tensor(kern),
                               k)
    d_mat = cols.permute(0, 2, 3, 1).reshape(feat, -1).numpy()
    b_d = np.broadcast_to(bias, (out_hw, out_hw, out_c)).reshape(-1)
    return d_mat, b_d


def pack_generator(generator: Generator, variant: str = "conv",
                   dtype: Optional[torch.dtype] = None) -> PackedGenerator:
    """Fold BN into the generator's weights; build the requested variant.

    dtype defaults to the generator's compute dtype (as in the JAX
    package); float32 gives the unrounded pack of the same weights.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown packed variant {variant!r}")
    dtype = dtype or generator.dtype
    device = generator.fc_in.weight.device
    hw, c0 = generator.base_hw, generator.channels[0]

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device, dtype)

    w = _np(generator.fc_in.weight).T                 # [k, hw*hw*c0]
    b = _np(generator.fc_in.bias)
    s, t = _bn_of(generator.bn_in)
    s_full = np.tile(s, hw * hw)                      # (y, x, c) order
    t_full = np.tile(t, hw * hw)
    w_fc = dev(w * s_full[None, :])
    b_fc = dev(b * s_full + t_full)

    convs = []
    n_blocks = len(generator.channels) - 1
    for i in range(n_blocks):
        deconv = getattr(generator, f"deconv_{i}")
        s, t = _bn_of(getattr(generator, f"bn_{i}"))
        kern = _np(deconv.weight) * s[None, :, None, None]
        convs.append((kern, _np(deconv.bias) * s + t, True))
    convs.append((_np(generator.deconv_out.weight),
                  _np(generator.deconv_out.bias), False))

    out_hw, out_c = generator.output_hw, generator.out_channels
    ksize = generator.kernel
    common = dict(variant=variant, base_hw=hw, out_hw=out_hw,
                  out_channels=out_c, w_fc=w_fc, b_fc=b_fc, dtype=dtype,
                  kernel=ksize)
    if variant == "s2d":
        if n_blocks > 1:
            raise ValueError(
                "variant='s2d' covers stacks of at most two deconvs (the "
                "s2d kernel density grows 4x per extra level); got "
                f"{n_blocks + 1}")
        s2d_convs = []
        f_in, cin = 1, c0
        for kern, bias, relu in convs:
            f_out = 2 * f_in
            weight = torch.as_tensor(kern)

            def lin_fn(x, weight=weight, f_in=f_in, cin=cin, f_out=f_out):
                h = _s2d_inv(x, f_in, cin) if f_in > 1 else x
                y = conv_transpose_same(h.permute(0, 3, 1, 2), weight, ksize)
                return _s2d(y.permute(0, 2, 3, 1), f_out)

            k_s2d = _probe_grid_conv(lin_fn, hw, f_in * f_in * cin)
            s2d_convs.append((dev(k_s2d), dev(np.tile(bias, f_out * f_out)),
                              relu))
            f_in, cin = f_out, kern.shape[1]
        perm_np = _s2d_flat_perm(out_hw, f_in, out_c)
        perm = tuple(torch.as_tensor(p).to(device)
                     for p in (perm_np, np.argsort(perm_np)))
        return PackedGenerator(convs=tuple(s2d_convs), dense=(), perm=perm,
                               **common)
    if variant in ("dense", "hybrid"):
        if variant == "dense" and n_blocks != 0:
            raise ValueError("variant='dense' covers the single-deconv wide "
                             "arch only (len(channels) must be 1); use "
                             "'hybrid' for deep archs")
        kern, bias, _ = convs[-1]
        d_mat, b_d = _dense_of(kern, bias, variant, out_hw, out_c, ksize)
        # inner deconvs (hybrid deep path) stay folded transpose convs
        return PackedGenerator(
            convs=tuple((dev(k), dev(bb), relu) for k, bb, relu in convs[:-1]),
            dense=(dev(d_mat), dev(b_d)), **common)
    if variant == "phase":
        return PackedGenerator(
            convs=tuple((phase_decompose(_hwio(k), bb, to=dev), relu)
                        for k, bb, relu in convs),
            dense=(), **common)
    return PackedGenerator(
        convs=tuple((dev(k), dev(bb), relu) for k, bb, relu in convs),
        dense=(), **common)


def make_packed_apply(packed: PackedGenerator) -> Callable:
    """Return gen_apply_flat: z [N, k] -> tanh images [N, H*W*C] (f32)."""
    dt = packed.dtype
    hw = packed.base_hw

    def fc_grid(z):
        """relu(fc) on the base grid, NHWC [N, hw, hw, c0]."""
        h = torch.relu(z.to(dt) @ packed.w_fc + packed.b_fc)
        return h.reshape(h.shape[0], hw, hw, -1)

    def flat_tanh(h):
        out = torch.tanh(h).to(torch.float32)
        return out.reshape(out.shape[0], -1)

    if packed.variant == "dense":
        d_mat, b_d = packed.dense

        def apply_flat(z):
            h = torch.relu(z.to(dt) @ packed.w_fc + packed.b_fc)
            return torch.tanh(h @ d_mat + b_d).to(torch.float32)

        return apply_flat

    if packed.variant == "s2d":
        # whole stack on the base grid: stride-1 SAME convs over s2d
        # channels; the output stays in s2d pixel order (packed.perm)
        def apply_flat(z):
            h = fc_grid(z)
            for kern, bias, relu in packed.convs:
                r = kern.shape[0] // 2
                h = _conv_nhwc(h, kern, ((r, r), (r, r))) + bias
                if relu:
                    h = torch.relu(h)
            return flat_tanh(h)

        return apply_flat

    if packed.variant == "phase":
        def apply_flat(z):
            h = fc_grid(z)
            for pc, relu in packed.convs:
                h = apply_phase_conv(pc, h)
                if relu:
                    h = torch.relu(h)
            return flat_tanh(h)

        return apply_flat

    def apply_flat(z):                                # conv, hybrid
        h = fc_grid(z).permute(0, 3, 1, 2)
        for kern, bias, relu in packed.convs:
            h = conv_transpose_same(h, kern, packed.kernel) \
                + bias[None, :, None, None]
            if relu:
                h = torch.relu(h)
        h = h.permute(0, 2, 3, 1)
        if packed.variant == "hybrid":
            d_mat, b_d = packed.dense
            o = h.reshape(h.shape[0], -1) @ d_mat + b_d
            return torch.tanh(o).to(torch.float32)
        return flat_tanh(h)

    return apply_flat


def packed_apply_for(generator: Generator, variant: str = "conv"
                     ) -> Callable:
    """Pack the frozen generator; returns gen_apply_flat."""
    return make_packed_apply(pack_generator(generator, variant))
