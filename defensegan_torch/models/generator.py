"""DCGAN-style WGAN generators (port of the JAX package's
models/generator.py).

z in R^latent_dim -> fc -> BatchNorm -> relu -> [stride-2 deconv -> BN ->
relu]* -> stride-2 deconv -> tanh image. The fc output is laid out in
(y, x, c) order, as flax reshapes it; images leave the module NHWC in the
generator's tanh space [-1, 1], float32. BatchNorm uses the running
averages, or in training mode the batch statistics (models/layers.py).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from defensegan_torch.models.layers import BatchNorm, ConvTranspose, Dense


def to_image_space(g: torch.Tensor) -> torch.Tensor:
    """Map generator output from [-1, 1] (tanh) to [0, 1] image space."""
    return (g + 1.0) * 0.5


def from_image_space(x: torch.Tensor) -> torch.Tensor:
    """Map [0, 1] images to the generator's [-1, 1] space.

    uint8 inputs ([0, 255]) are normalized on the device they arrive on:
    serving inputs are uint8 images, a quarter of float32's upload.
    """
    if x.dtype == torch.uint8:
        return x.to(torch.float32) * (2.0 / 255.0) - 1.0
    return x * 2.0 - 1.0


class Generator(nn.Module):
    """Conv-transpose generator: z [N, k] -> images [N, H, W, C] in [-1, 1].

    Submodule names are the flax ones (fc_in, bn_in, deconv_i, bn_i,
    deconv_out), which is what ckpt/bridge.py maps by.
    """

    def __init__(self, latent_dim: int = 128, base_hw: int = 7,
                 channels: Sequence[int] = (128, 64), out_channels: int = 1,
                 kernel: int = 5, dtype=torch.float32,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.latent_dim = latent_dim
        self.base_hw = base_hw
        self.channels = tuple(channels)
        self.out_channels = out_channels
        self.kernel = kernel
        self.dtype = dtype
        c0 = self.channels[0]
        self.fc_in = Dense(latent_dim, base_hw * base_hw * c0, dtype, gen)
        self.bn_in = BatchNorm(c0, dtype=dtype)
        c_prev = c0
        for i, c in enumerate(self.channels[1:]):
            self.add_module(f"deconv_{i}",
                            ConvTranspose(c_prev, c, kernel, 2, dtype, gen))
            self.add_module(f"bn_{i}", BatchNorm(c, dtype=dtype))
            c_prev = c
        self.deconv_out = ConvTranspose(c_prev, out_channels, kernel, 2,
                                        dtype, gen)

    @property
    def output_hw(self) -> int:
        return self.base_hw * (2 ** len(self.channels))

    def forward(self, z: torch.Tensor, train: bool = False,
                update_stats: bool = False, group=None) -> torch.Tensor:
        """train: BatchNorm on the batch statistics (flax train=True);
        update_stats: also fold them into the running averages, as the
        generator step of WGAN-GP training does (flax mutable
        batch_stats); group: the statistics of the process group's global
        batch (models/layers.py::BatchNorm)."""
        hw, c0 = self.base_hw, self.channels[0]
        bn = dict(train=train, update_stats=update_stats, group=group)
        h = self.fc_in(z)
        h = h.reshape(h.shape[0], hw, hw, c0).permute(0, 3, 1, 2)
        h = torch.relu(self.bn_in(h, **bn))
        for i in range(len(self.channels) - 1):
            h = getattr(self, f"deconv_{i}")(h)
            h = torch.relu(getattr(self, f"bn_{i}")(h, **bn))
        h = self.deconv_out(h)
        return torch.tanh(h).to(torch.float32).permute(0, 2, 3, 1)


def generator_for(dataset: str, dim: int = 64, dtype=torch.float32,
                  arch: str = "deep", latent_dim: int = 128,
                  gen: torch.Generator | None = None) -> Generator:
    """The per-dataset generator (the JAX package's generator_for).

    arch="deep": MNIST family 7 -> 14 -> 28, 1 channel; CelebA /
    ImageNet-64 4 -> 8 -> 16 -> 32 -> 64, 3 channels.
    arch="wide": MNIST family fc -> 14x14x(2*dim) -> deconv -> 28; CelebA
    family 8 -> 16 -> 32 -> 64.
    """
    name = dataset.lower().replace("-", "").replace("_", "")
    kw = dict(latent_dim=latent_dim, dtype=dtype, gen=gen)
    if name in ("mnist", "fmnist", "fashionmnist", "digits"):
        if arch == "wide":
            return Generator(base_hw=14, channels=(2 * dim,),
                             out_channels=1, **kw)
        return Generator(base_hw=7, channels=(2 * dim, dim), out_channels=1,
                         **kw)
    if name in ("celeba", "imagenet64"):
        if arch == "wide":
            return Generator(base_hw=8, channels=(4 * dim, 2 * dim, dim),
                             out_channels=3, **kw)
        return Generator(base_hw=4, channels=(8 * dim, 4 * dim, 2 * dim, dim),
                         out_channels=3, **kw)
    raise ValueError(f"unknown dataset {dataset!r}")
