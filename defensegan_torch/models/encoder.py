"""Amortized-inversion encoder E(x) -> z (port of models/encoder.py).

Strided 5x5 SAME convs + LeakyReLU(0.2), then a Dense to z_dim on the
NHWC-flattened features (flax's flatten order). Input is TANH-space images
[-1, 1], NHWC; defense/encoder_init.py handles the [0, 1] conversion.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from defensegan_torch.models.layers import Conv, Dense


class Encoder(nn.Module):
    def __init__(self, channels: Sequence[int] = (64, 128), z_dim: int = 128,
                 kernel: int = 5, in_channels: int = 1, image_size: int = 28,
                 dtype=torch.float32, gen: torch.Generator | None = None):
        super().__init__()
        self.channels = tuple(channels)
        self.z_dim = z_dim
        self.dtype = dtype
        c_prev, hw = in_channels, image_size
        for i, c in enumerate(self.channels):
            self.add_module(f"conv_{i}",
                            Conv(c_prev, c, kernel, 2, "SAME", dtype, gen))
            c_prev, hw = c, -(-hw // 2)
        self.fc_z = Dense(hw * hw * c_prev, z_dim, dtype, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for i in range(len(self.channels)):
            h = F.leaky_relu(getattr(self, f"conv_{i}")(h), 0.2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return self.fc_z(h).to(torch.float32)


def encoder_for(dataset: str, dim: int = 64, z_dim: int = 128,
                dtype=torch.float32,
                gen: torch.Generator | None = None) -> Encoder:
    """Per-dataset encoder, topology-matched to the critic."""
    name = dataset.lower().replace("-", "").replace("_", "")
    if name in ("mnist", "fmnist", "fashionmnist", "digits"):
        return Encoder(channels=(dim, 2 * dim), z_dim=z_dim, in_channels=1,
                       image_size=28, dtype=dtype, gen=gen)
    if name in ("celeba", "imagenet64"):
        return Encoder(channels=(dim, 2 * dim, 4 * dim, 8 * dim),
                       z_dim=z_dim, in_channels=3, image_size=64,
                       dtype=dtype, gen=gen)
    raise ValueError(f"unknown dataset {dataset!r}")
