"""The amortized-inversion encoder E(x) -> z of the encoder-initialised
projection, plain (flax semantics).

Defense-GAN's projection may start one restart at an encoder's guess of
z instead of a draw. The encoder: strided k x k convolutions with flax's
SAME padding (out = ceil(h / s), total = max((out - 1) s + k - h, 0),
low = total // 2), each followed by its bias and LeakyReLU, then the
features flattened in NHWC order and a dense layer to z. Weights are a
dict of float32 tensors under the flax paths of the repository's weight
export, without the module prefix: `conv_i/kernel` HWIO, `conv_i/bias`,
`fc_z/kernel` [features, z_dim], `fc_z/bias`. Input: tanh-space images
[N, H, W, C]; output: z [N, z_dim], float32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference.classifier import same_pads
from benchmark.reference.numerics import FP32, Precision


class EncoderShape(NamedTuple):
    channels: Sequence[int]
    z_dim: int
    in_channels: int
    image_size: int
    kernel: int = 5
    stride: int = 2
    negative_slope: float = 0.2

    @property
    def features(self) -> int:
        """The width the dense layer reads."""
        hw = self.image_size
        for _ in self.channels:
            hw = -(-hw // self.stride)
        return hw * hw * self.channels[-1]


def weight_shapes(shape: EncoderShape) -> Dict[str, tuple]:
    """Every tensor the encoder takes, by path."""
    out, c_in = {}, shape.in_channels
    for i, c in enumerate(shape.channels):
        out[f"conv_{i}/kernel"] = (shape.kernel, shape.kernel, c_in, c)
        out[f"conv_{i}/bias"] = (c,)
        c_in = c
    out["fc_z/kernel"] = (shape.features, shape.z_dim)
    out["fc_z/bias"] = (shape.z_dim,)
    return out


def encode(w: Dict[str, torch.Tensor], shape: EncoderShape, x: torch.Tensor,
           prec: Precision = FP32) -> torch.Tensor:
    """z [N, z_dim] of tanh-space images x [N, H, W, C]."""
    q = prec.operand
    h = x.float().permute(0, 3, 1, 2)
    for i in range(len(shape.channels)):
        py = same_pads(h.shape[2], shape.kernel, shape.stride)
        px = same_pads(h.shape[3], shape.kernel, shape.stride)
        h = F.pad(h, (px[0], px[1], py[0], py[1]))
        h = F.conv2d(q(h), q(w[f"conv_{i}/kernel"].permute(3, 2, 0, 1)),
                     stride=shape.stride)
        h = h + w[f"conv_{i}/bias"][None, :, None, None]
        h = F.leaky_relu(h, shape.negative_slope)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return q(h) @ q(w["fc_z/kernel"]) + w["fc_z/bias"]
