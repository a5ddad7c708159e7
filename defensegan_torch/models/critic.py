"""WGAN critic (port of the JAX package's models/critic.py).

Reference parity: models/gan.py::discriminator_fn of kabkabm/defensegan:
strided 5x5 SAME convs + LeakyReLU(0.2), NO normalization (WGAN-GP
penalizes each sample's gradient, which BatchNorm would couple), and a
Dense to one Wasserstein score. Images enter NHWC in the generator's tanh
space [-1, 1]; features are flattened in NHWC order, as flax flattens
them. Submodule names are the flax ones (conv_i, fc_out), which
ckpt/bridge.py maps by.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from defensegan_torch.models.layers import Conv, Dense


class Critic(nn.Module):
    """images [N, H, W, C] -> scores [N], float32.

    channels: per-downsampling-block output channels, finest first; the
    compute dtype applies to every layer, the parameters stay float32.
    """

    def __init__(self, channels: Sequence[int] = (64, 128), kernel: int = 5,
                 in_channels: int = 1, image_size: int = 28,
                 dtype=torch.float32, gen: torch.Generator | None = None):
        super().__init__()
        self.channels = tuple(channels)
        self.dtype = dtype
        c_prev, hw = in_channels, image_size
        for i, c in enumerate(self.channels):
            self.add_module(f"conv_{i}",
                            Conv(c_prev, c, kernel, 2, "SAME", dtype, gen))
            c_prev, hw = c, -(-hw // 2)
        self.fc_out = Dense(hw * hw * c_prev, 1, dtype, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for i in range(len(self.channels)):
            h = F.leaky_relu(getattr(self, f"conv_{i}")(h), 0.2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return self.fc_out(h).to(torch.float32)[:, 0]


def critic_for(dataset: str, dim: int = 64, dtype=torch.float32,
               gen: torch.Generator | None = None) -> Critic:
    """The per-dataset critic: (dim, 2 dim) on the MNIST family's 28x28x1,
    (dim, 2 dim, 4 dim, 8 dim) on the 64x64x3 family."""
    name = dataset.lower().replace("-", "").replace("_", "")
    if name in ("mnist", "fmnist", "fashionmnist", "digits"):
        return Critic(channels=(dim, 2 * dim), in_channels=1, image_size=28,
                      dtype=dtype, gen=gen)
    if name in ("celeba", "imagenet64"):
        return Critic(channels=(dim, 2 * dim, 4 * dim, 8 * dim),
                      in_channels=3, image_size=64, dtype=dtype, gen=gen)
    raise ValueError(f"unknown dataset {dataset!r}")
