"""The WGAN generator of Defense-GAN, plain (flax semantics, NHWC out).

z [N, k] -> fc -> BatchNorm -> relu -> [deconv -> BatchNorm -> relu]* ->
deconv -> tanh, every deconv a 5x5 stride-2 SAME transpose convolution
(github.com/kabkabm/defensegan, models/generator; the wide form has one
deconv after a wider fc). Weights are a dict of float32 tensors under the
flax paths of the repository's weight export, without the module prefix:
`fc_in/kernel` [k, hw*hw*c0] (features in (y, x, c) order),
`deconv_i/kernel` and `deconv_out/kernel` HWIO, BatchNorm `bn_*/scale`,
`bias`, `mean`, `var` (inference: the running statistics, eps 1e-5).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference.numerics import FP32, Precision

BN_EPS = 1e-5


class GeneratorShape(NamedTuple):
    latent_dim: int
    base_hw: int
    channels: Sequence[int]
    out_channels: int
    kernel: int = 5
    stride: int = 2

    @property
    def output_hw(self) -> int:
        return self.base_hw * self.stride ** len(self.channels)

    @property
    def out_dim(self) -> int:
        return self.output_hw ** 2 * self.out_channels


def transpose_pads(k: int, s: int):
    """(lo, hi) padding of the stride-dilated input in flax's SAME
    transpose convolution (lax.conv_transpose with padding='SAME'): the
    output is s times the input, the kernel is not flipped."""
    lo = k - 1 if s > k - 1 else (k + s - 1) // 2
    return lo, k + s - 2 - lo


def deconv_literal(x: torch.Tensor, kernel: torch.Tensor,
                   s: int) -> torch.Tensor:
    """flax SAME transpose conv of NCHW x by its definition: dilate x by
    s, pad (lo, hi), cross-correlate with the HWIO kernel."""
    k = kernel.shape[0]
    lo, hi = transpose_pads(k, s)
    n, c, h, w = x.shape
    xd = x.new_zeros((n, c, (h - 1) * s + 1, (w - 1) * s + 1))
    xd[:, :, ::s, ::s] = x
    xd = F.pad(xd, (lo, hi, lo, hi))
    return F.conv2d(xd, kernel.permute(3, 2, 0, 1))


def deconv(x: torch.Tensor, kernel: torch.Tensor, s: int) -> torch.Tensor:
    """The same map as deconv_literal, as one conv_transpose2d: PyTorch's
    transpose conv pads k - 1 - p on both sides and flips the kernel, so
    p = k - 1 - lo and the flipped kernel give flax's low side; the high
    side then has lo - hi extra rows and columns, cropped."""
    k = kernel.shape[0]
    lo, hi = transpose_pads(k, s)
    if lo < hi:
        raise ValueError(f"k={k}, s={s}: pads ({lo}, {hi}) need "
                         "output padding, which this form does not take")
    w = kernel.flip(0, 1).permute(2, 3, 0, 1)
    y = F.conv_transpose2d(x, w, stride=s, padding=k - 1 - lo)
    return y[:, :, :x.shape[2] * s, :x.shape[3] * s]


def batch_norm(h: torch.Tensor, w: Dict[str, torch.Tensor],
               name: str) -> torch.Tensor:
    def c(v):
        return v[None, :, None, None]
    mul = torch.rsqrt(w[f"{name}/var"] + BN_EPS) * w[f"{name}/scale"]
    return (h - c(w[f"{name}/mean"])) * c(mul) + c(w[f"{name}/bias"])


def generate(w: Dict[str, torch.Tensor], shape: GeneratorShape,
             z: torch.Tensor, prec: Precision = FP32) -> torch.Tensor:
    """tanh-space images [N, H, W, C], float32."""
    q, qg = prec.operand, prec.grad_operand
    hw, c0 = shape.base_hw, shape.channels[0]
    h = qg(q(z) @ q(w["fc_in/kernel"])) + w["fc_in/bias"]
    h = h.reshape(z.shape[0], hw, hw, c0).permute(0, 3, 1, 2)
    h = torch.relu(batch_norm(h, w, "bn_in"))
    for i in range(len(shape.channels) - 1):
        h = qg(deconv(q(h), q(w[f"deconv_{i}/kernel"]), shape.stride))
        h = h + w[f"deconv_{i}/bias"][None, :, None, None]
        h = torch.relu(batch_norm(h, w, f"bn_{i}"))
    o = qg(deconv(q(h), q(w["deconv_out/kernel"]), shape.stride))
    o = o + w["deconv_out/bias"][None, :, None, None]
    return torch.tanh(o).permute(0, 2, 3, 1)


def layer_names(shape: GeneratorShape):
    """The flax module names of a generator of this shape, in order."""
    names = ["fc_in", "bn_in"]
    for i in range(len(shape.channels) - 1):
        names += [f"deconv_{i}", f"bn_{i}"]
    return names + ["deconv_out"]


def weight_shapes(shape: GeneratorShape) -> Dict[str, tuple]:
    """Every tensor the generator takes, by path."""
    k, hw, ch = shape.latent_dim, shape.base_hw, list(shape.channels)
    out = {"fc_in/kernel": (k, hw * hw * ch[0]),
           "fc_in/bias": (hw * hw * ch[0],)}
    bns = [("bn_in", ch[0])]
    convs = []
    for i in range(len(ch) - 1):
        convs.append((f"deconv_{i}", ch[i], ch[i + 1]))
        bns.append((f"bn_{i}", ch[i + 1]))
    convs.append(("deconv_out", ch[-1], shape.out_channels))
    for name, cin, cout in convs:
        out[f"{name}/kernel"] = (shape.kernel, shape.kernel, cin, cout)
        out[f"{name}/bias"] = (cout,)
    for name, c in bns:
        for leaf in ("scale", "bias", "mean", "var"):
            out[f"{name}/{leaf}"] = (c,)
    return out
