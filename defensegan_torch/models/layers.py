"""Flax-equivalent layers for the port's models.

Each layer computes what its flax.linen counterpart computes, with the
parameters in PyTorch's layouts (ckpt/bridge.py converts):

  Dense          flax nn.Dense         weight [out, in]
  Conv           flax nn.Conv          weight OIHW; SAME pads split as
                                       lax does (low = total // 2)
  ConvTranspose  flax nn.ConvTranspose weight [in, out, kh, kw], spatially
                                       FLIPPED (see below)
  BatchNorm      flax nn.BatchNorm     running statistics (inference) or
                                       batch statistics (training), eps
                                       1e-5, computed in float32 and
                                       rounded to the compute dtype

Activations are NCHW inside the modules; the models keep the JAX package's
NHWC layout at their public calls.

Compute dtype: flax casts inputs, weights and biases to `dtype`, computes
the product in it and adds the bias in it; these layers do the same, so a
bfloat16 model rounds where the flax one does.

ConvTranspose: flax's SAME stride-2 transpose convolution is a
cross-correlation of the stride-dilated input, padded (lo, hi) = (3, 2) for
k = 5, with the kernel NOT flipped. torch's conv_transpose2d is the same
correlation with the kernel flipped and symmetric padding k - 1 - p; with
the flipped weight and p = k - 1 - lo it pads (lo, lo), one more row and
column on the high side than flax, which the crop to in * stride removes.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def same_pads(size: int, k: int, s: int):
    """(lo, hi) SAME padding of lax.padtype_to_pads for one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_transpose_pads(k: int, s: int):
    """(lo, hi) padding of the dilated input in lax.conv_transpose SAME."""
    lo = k - 1 if s > k - 1 else -((k + s - 2) // -2)
    return lo, k + s - 2 - lo


def conv_transpose_same(x: torch.Tensor, weight: torch.Tensor, k: int = 5,
                        s: int = 2) -> torch.Tensor:
    """flax SAME transpose conv of NCHW x, bias-free, in x's dtype.

    weight is [in, out, kh, kw] in the flipped layout (module docstring).
    """
    lo, hi = conv_transpose_pads(k, s)
    y = F.conv_transpose2d(x, weight.to(x.dtype), stride=s,
                           padding=k - 1 - lo,
                           output_padding=max(hi - lo, 0))
    return y[:, :, :x.shape[2] * s, :x.shape[3] * s]


def _lecun_normal(shape, fan_in: int, gen: torch.Generator | None):
    return torch.randn(shape, generator=gen) / math.sqrt(fan_in)


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, dtype=torch.float32,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(_lecun_normal((d_out, d_in), d_in, gen))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        dt = self.dtype
        return x.to(dt) @ self.weight.to(dt).t() + self.bias.to(dt)


class Conv(nn.Module):
    """SAME or VALID 2-D convolution on NCHW activations."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 padding: str = "SAME", dtype=torch.float32,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.k, self.stride, self.padding, self.dtype = k, stride, padding, \
            dtype
        self.weight = nn.Parameter(
            _lecun_normal((c_out, c_in, k, k), c_in * k * k, gen))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):
        dt = self.dtype
        x = x.to(dt)
        if self.padding == "SAME":
            py = same_pads(x.shape[2], self.k, self.stride)
            px = same_pads(x.shape[3], self.k, self.stride)
            x = F.pad(x, (px[0], px[1], py[0], py[1]))
        y = F.conv2d(x, self.weight.to(dt), stride=self.stride)
        return y + self.bias.to(dt)[None, :, None, None]


class ConvTranspose(nn.Module):
    """flax nn.ConvTranspose(padding="SAME") on NCHW activations."""

    def __init__(self, c_in: int, c_out: int, k: int = 5, stride: int = 2,
                 dtype=torch.float32, gen: torch.Generator | None = None):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        # flax's lecun_normal fan-in of an HWIO transpose kernel is k*k*in
        self.weight = nn.Parameter(
            _lecun_normal((c_in, c_out, k, k), c_in * k * k, gen))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def linear(self, x):
        """The bias-free transpose convolution, in x's dtype."""
        return conv_transpose_same(x, self.weight, self.k, self.stride)

    def forward(self, x):
        dt = self.dtype
        return self.linear(x.to(dt)) + self.bias.to(dt)[None, :, None, None]


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group's ranks, differentiable: every rank's loss
    depends on every rank's input, so the gradient is summed too."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis of NCHW activations, with flax's
    semantics.

    Inference (train=False) normalizes with the running statistics.
    Training normalizes with the batch mean and the BIASED batch variance,
    both computed in float32 as E[x^2] - E[x]^2 clipped at 0 (flax's fast
    variance), and differentiable. update_stats=True also folds them into
    the running statistics as ra = 0.99 ra + 0.01 batch, the variance kept
    biased. F.batch_norm's running update differs on both counts (momentum
    0.1, unbiased variance), so it is not used.

    group (a torch.distributed process group, training only): the batch
    moments E[x] and E[x^2] are averaged over the group's ranks by one
    differentiable all-reduce, so with equal shards the statistics are the
    global batch's (the JAX package's GSPMD step computes them over the
    whole sharded batch).
    """

    momentum = 0.99

    def __init__(self, c: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x, train: bool = False, update_stats: bool = False,
                group=None):
        xf = x.float()
        if train:
            mean = xf.mean((0, 2, 3))
            sq = (xf * xf).mean((0, 2, 3))
            if group is not None:
                import torch.distributed as dist
                both = _AllReduceSum.apply(torch.stack([mean, sq]), group)
                both = both / dist.get_world_size(group)
                mean, sq = both[0], both[1]
            var = torch.clamp_min(sq - mean * mean, 0.0)
            if update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.mul_(m).add_((1.0 - m) * mean)
                    self.var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        return batch_norm(xf, mean, var, self.scale, self.bias, self.eps,
                          self.dtype)


def batch_norm(xf: torch.Tensor, mean, var, scale, bias, eps: float,
               dtype) -> torch.Tensor:
    """Normalize float32 NCHW `xf` per channel with the given statistics
    and affine parameters, rounded to `dtype` (BatchNorm's arithmetic)."""
    def c(v):
        return v[None, :, None, None]
    mul = torch.rsqrt(var + eps) * scale
    y = (xf - c(mean)) * c(mul) + c(bias)
    return y.to(dtype)
