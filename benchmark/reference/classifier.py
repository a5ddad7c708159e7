"""Model A of the Defense-GAN paper (arXiv:1805.06605, appendix Table 5),
plain, at inference: Conv(64, 5x5, 1) - relu - Conv(64, 5x5, 2) - relu -
FC(128) - relu - FC(10); the dropouts are off at inference.

flax semantics, as the repository's weight exports lay them out:
SAME padding split as lax.padtype_to_pads does (low = total // 2),
kernels HWIO, Dense kernels [in, out], features flattened in NHWC order
before the first Dense. Input: [0, 1] images NHWC; output: logits.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.numerics import FP32, Precision

# (flax name, kind, stride)
LAYERS = (("Conv_0", "conv", 1), ("Conv_1", "conv", 2),
          ("Dense_0", "dense", None), ("Dense_1", "dense", None))


def same_pads(size: int, k: int, s: int):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def weight_shapes(num_classes: int = 10, hw: int = 28,
                  c_in: int = 1) -> Dict[str, tuple]:
    out_hw = -(-hw // 2)
    return {"Conv_0/kernel": (5, 5, c_in, 64), "Conv_0/bias": (64,),
            "Conv_1/kernel": (5, 5, 64, 64), "Conv_1/bias": (64,),
            "Dense_0/kernel": (out_hw * out_hw * 64, 128),
            "Dense_0/bias": (128,),
            "Dense_1/kernel": (128, num_classes),
            "Dense_1/bias": (num_classes,)}


def logits(w: Dict[str, torch.Tensor], x: torch.Tensor,
           prec: Precision = FP32) -> torch.Tensor:
    q = prec.operand
    h = x.float().permute(0, 3, 1, 2)
    flat = False
    for i, (name, kind, stride) in enumerate(LAYERS):
        kern, bias = w[f"{name}/kernel"], w[f"{name}/bias"]
        if kind == "conv":
            k = kern.shape[0]
            py = same_pads(h.shape[2], k, stride)
            px = same_pads(h.shape[3], k, stride)
            h = F.pad(h, (px[0], px[1], py[0], py[1]))
            h = F.conv2d(q(h), q(kern.permute(3, 2, 0, 1)), stride=stride)
            h = h + bias[None, :, None, None]
        else:
            if not flat:
                h, flat = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1), True
            h = q(h) @ q(kern) + bias
        if i != len(LAYERS) - 1:
            h = torch.relu(h)
    return h
