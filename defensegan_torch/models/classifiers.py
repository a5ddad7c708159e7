"""Classifier zoo A-F (port of the JAX package's models/classifiers.py).

The Defense-GAN paper's appendix Table 5 models. They take [0, 1] images
NHWC and return float32 LOGITS. Submodules carry flax's automatic names
(Conv_0, Dense_0, ...) so ckpt/bridge.py maps weights by name; features are
flattened in NHWC order before the first Dense, as flax flattens them.

Dropout sits where the JAX zoo has it, at its rates (A and C: 0.25 after
the conv stack and 0.5 after FC(128); B: 0.2 on the input and 0.5 before
the last FC; D: 0.5 after each FC(300); E and F have none). It is active
only in training mode, which is a call with a `dropout` torch.Generator:
the masks come from it (flax semantics: keep with probability 1 - rate,
kept values scaled by 1 / (1 - rate)). Without one, the forward is the
inference forward (flax train=False).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from defensegan_torch.models.layers import Conv, Dense


def _flatten_nhwc(h: torch.Tensor) -> torch.Tensor:
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


class _Zoo(nn.Module):
    """Sequential conv/pool/dense stack described by a layer list.

    layers: ("conv", c_out, k, stride, padding) | ("pool",) | ("dense", d)
    | ("drop", rate), with relu after every conv and dense but the last
    Dense.
    """

    def __init__(self, layers, num_classes: int = 10, in_hw: int = 28,
                 in_c: int = 1, dtype=torch.float32,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.plan = []
        n_conv = n_dense = 0
        c, hw, flat = in_c, in_hw, None
        for spec in list(layers) + [("dense", num_classes)]:
            if spec[0] == "conv":
                _, c_out, k, s, pad = spec
                name = f"Conv_{n_conv}"
                n_conv += 1
                self.add_module(name, Conv(c, c_out, k, s, pad, dtype, gen))
                hw = -(-hw // s) if pad == "SAME" else (hw - k) // s + 1
                c = c_out
            elif spec[0] == "pool":
                name = "pool"
                hw //= 2
            elif spec[0] == "drop":
                self.plan.append(spec)
                continue
            else:
                name = f"Dense_{n_dense}"
                n_dense += 1
                d_in = flat if flat is not None else hw * hw * c
                self.add_module(name, Dense(d_in, spec[1], dtype, gen))
                flat = spec[1]
            self.plan.append(name)

    def forward(self, x: torch.Tensor,
                dropout: torch.Generator | None = None) -> torch.Tensor:
        """Logits of [0, 1] NHWC images; `dropout` (a generator on x's
        device) turns on training-mode dropout."""
        h = x.to(self.dtype).permute(0, 3, 1, 2)
        flat = False
        last = len(self.plan) - 1
        for i, name in enumerate(self.plan):
            if isinstance(name, tuple):                    # ("drop", rate)
                if dropout is not None:
                    keep = 1.0 - name[1]
                    mask = torch.rand(h.shape, generator=dropout,
                                      device=h.device) < keep
                    h = torch.where(mask, h / keep, torch.zeros_like(h))
                continue
            if name == "pool":
                h = F.max_pool2d(h, 2, 2)
                continue
            if name.startswith("Dense") and not flat:
                h, flat = _flatten_nhwc(h), True
            h = getattr(self, name)(h)
            if i != last:
                h = torch.relu(h)
        return h.to(torch.float32)


_LAYERS = {
    # Conv(64,5,1)-Conv(64,5,2)-Drop(.25)-FC(128)-Drop(.5)-FC(10)
    "A": [("conv", 64, 5, 1, "SAME"), ("conv", 64, 5, 2, "SAME"),
          ("drop", 0.25), ("dense", 128), ("drop", 0.5)],
    # Drop(.2)-Conv(64,8,2)-Conv(128,6,2)-Conv(128,5,1)-Drop(.5)-FC(10)
    "B": [("drop", 0.2), ("conv", 64, 8, 2, "SAME"),
          ("conv", 128, 6, 2, "VALID"), ("conv", 128, 5, 1, "VALID"),
          ("drop", 0.5)],
    # Conv(128,3,1)-Conv(64,5,2)-Drop(.25)-FC(128)-Drop(.5)-FC(10)
    "C": [("conv", 128, 3, 1, "SAME"), ("conv", 64, 5, 2, "SAME"),
          ("drop", 0.25), ("dense", 128), ("drop", 0.5)],
    # [FC(300)-ReLU-Drop(.5)] x3 - FC(10)
    "D": [("dense", 300), ("drop", 0.5)] * 3,
    # FC(200)-ReLU-FC(200)-ReLU-FC(10)
    "E": [("dense", 200)] * 2,
    # Conv(32,5,1)-MaxPool-Conv(64,5,1)-MaxPool-FC(1024)-FC(10)
    "F": [("conv", 32, 5, 1, "SAME"), ("pool",), ("conv", 64, 5, 1, "SAME"),
          ("pool",), ("dense", 1024)],
}

CLASSIFIER_ZOO = tuple(sorted(_LAYERS))


def build_classifier(name: str, num_classes: int = 10, dtype=torch.float32,
                     image_shape=(28, 28, 1),
                     gen: torch.Generator | None = None) -> nn.Module:
    """Build classifier by letter, mirroring the reference's --model flag."""
    key = name.strip().upper()
    if key not in _LAYERS:
        raise ValueError(
            f"unknown classifier {name!r}; choose from {list(CLASSIFIER_ZOO)}")
    hw, _, c = image_shape
    return _Zoo(_LAYERS[key], num_classes, hw, c, dtype, gen)
