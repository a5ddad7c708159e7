"""Packed inference-time generators (port of defense/fastgen.py).

At inference the generator is a fixed chain z -> fc -> BN -> relu ->
[deconv -> BN -> relu]* -> deconv -> tanh, and every BatchNorm (running
averages) is an affine map folded into the adjacent weights once, at pack
time. Variants ported so far:

  variant="conv"   BN-folded weights, the deconvs stay transpose
                   convolutions.
  variant="dense"  (wide single-deconv arch only) the deconv is probed
                   with the identity basis into a dense [F, H*W*C] matrix,
                   so the generator is fc -> relu -> matmul -> tanh: the
                   form the fused projection kernels consume
                   (kernels/fused_projection_v2.py, _v2i.py).

The s2d / phase / hybrid packings come with the deep-generator kernel (v3).
Packed applies return FLAT tanh images [N, H*W*C] in NHWC pixel order,
float32; they compute in the generator's dtype and round where the JAX
package's packed apply rounds (after each product, bias add and tanh).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from defensegan_torch.models.generator import Generator
from defensegan_torch.models.layers import conv_transpose_same


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


class PackedGenerator(NamedTuple):
    """BN-folded generator weights + static topology.

    convs: per deconv (weight [in, out, kh, kw] in the port's flipped
    transpose-conv layout, bias, relu_after), for variant="conv".
    dense: (D [F, H*W*C], bD [H*W*C]) for variant="dense".
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


def pack_generator(generator: Generator, variant: str = "conv",
                   dtype: Optional[torch.dtype] = None) -> PackedGenerator:
    """Fold BN into the generator's weights; build the requested variant.

    dtype defaults to the generator's compute dtype (as in the JAX
    package); float32 gives the unrounded pack of the same weights.
    """
    if variant not in ("conv", "dense"):
        raise ValueError(f"packed variant {variant!r} is not ported "
                         "(the port packs 'conv' and 'dense')")
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
    common = dict(variant=variant, base_hw=hw, out_hw=out_hw,
                  out_channels=out_c, w_fc=w_fc, b_fc=b_fc, dtype=dtype,
                  kernel=generator.kernel)
    if variant == "dense":
        if n_blocks != 0:
            raise ValueError("variant='dense' covers the single-deconv wide "
                             "arch only (len(channels) must be 1)")
        kern, bias, _ = convs[-1]
        in_hw, in_c = out_hw // 2, kern.shape[0]
        feat = in_hw * in_hw * in_c
        if feat > 16384:
            raise ValueError(
                f"variant='dense' materializes the final deconv as a dense "
                f"[{feat}, {4 * feat}] matrix — too large for this topology "
                f"(final-deconv input {in_hw}x{in_hw}x{in_c}); use 'conv'")
        # identity probe through the same transpose conv: each output is
        # one kernel tap times 1.0, so the matrix is exact in float32
        eye = torch.eye(feat).reshape(feat, in_hw, in_hw, in_c)
        cols = conv_transpose_same(eye.permute(0, 3, 1, 2),
                                   torch.as_tensor(kern), generator.kernel)
        d_mat = cols.permute(0, 2, 3, 1).reshape(feat, -1).numpy()
        b_d = np.broadcast_to(bias, (out_hw, out_hw, out_c)).reshape(-1)
        return PackedGenerator(convs=(), dense=(dev(d_mat), dev(b_d)),
                               **common)
    return PackedGenerator(
        convs=tuple((dev(k), dev(bb), relu) for k, bb, relu in convs),
        dense=(), **common)


def make_packed_apply(packed: PackedGenerator) -> Callable:
    """Return gen_apply_flat: z [N, k] -> tanh images [N, H*W*C] (f32)."""
    dt = packed.dtype

    if packed.variant == "dense":
        d_mat, b_d = packed.dense

        def apply_flat(z):
            h = torch.relu(z.to(dt) @ packed.w_fc + packed.b_fc)
            return torch.tanh(h @ d_mat + b_d).to(torch.float32)

        return apply_flat

    hw = packed.base_hw

    def apply_flat(z):
        h = torch.relu(z.to(dt) @ packed.w_fc + packed.b_fc)
        h = h.reshape(h.shape[0], hw, hw, -1).permute(0, 3, 1, 2)
        for kern, bias, relu in packed.convs:
            h = conv_transpose_same(h, kern, packed.kernel) \
                + bias[None, :, None, None]
            if relu:
                h = torch.relu(h)
        out = torch.tanh(h).to(torch.float32).permute(0, 2, 3, 1)
        return out.reshape(out.shape[0], -1)

    return apply_flat


def packed_apply_for(generator: Generator, variant: str = "conv"
                     ) -> Callable:
    """Pack the frozen generator; returns gen_apply_flat."""
    return make_packed_apply(pack_generator(generator, variant))

