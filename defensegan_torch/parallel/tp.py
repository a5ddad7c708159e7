"""Tensor-parallel (model-axis) channel split of the generator (port of
the JAX package's parallel/tp.py): designed for, a non-goal for speed.

At Defense-GAN's sizes (< 20 M parameters) tensor parallelism buys
nothing, but the port keeps the JAX package's design executable: a 2-D
("data", "model") device mesh, the Megatron channel split of each layer's
parameters by layer type, and a generator forward in which every model
rank computes its share of a layer's output channels and all-gathers them
before the next layer, which is what GSPMD inserts for the JAX package.
The collectives are explicit (torch.distributed), not DTensor.

Rules (torch layouts, models/layers.py):
  Dense          weight [out, in]           -> split dim 0 (out)
  Conv           weight [out, in, kh, kw]   -> split dim 0 (out)
  ConvTranspose  weight [in, out, kh, kw]   -> split dim 1 (out)
  1-D leaves (biases, BatchNorm scale / bias / statistics) -> dim 0
  anything else                              -> replicated
A leaf whose split axis does not divide the model axis's size stays
replicated (odd channel counts must not fail placement).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from defensegan_torch.models.layers import (BatchNorm, Conv, ConvTranspose,
                                            Dense, batch_norm,
                                            conv_transpose_same)
from defensegan_torch.parallel.mesh import DATA_AXIS

MODEL_AXIS = "model"

# name -> (the rank's tensor, the split dim or None when replicated)
TPShards = Dict[str, Tuple[torch.Tensor, Optional[int]]]


def make_mesh_2d(n_data: int, n_model: int):
    """A ("data", "model") DeviceMesh over the whole process group
    (n_data * n_model ranks; the model axis innermost, so a model group is
    consecutive ranks). The device type follows the group's backend:
    cuda under NCCL, cpu under gloo."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh_2d needs a process group "
                           "(parallel/distributed.py::initialize_distributed)")
    need, world = n_data * n_model, dist.get_world_size()
    if need != world:
        raise ValueError(f"requested {n_data}x{n_model}={need} ranks, the "
                         f"group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def tp_spec(module: nn.Module, name: str) -> Optional[int]:
    """The dim a leaf `name` of `module` (a layer of models/layers.py) is
    split on along the model axis, or None (replicated)."""
    leaf = getattr(module, name)
    if leaf.ndim == 1:
        return 0
    if isinstance(module, ConvTranspose) and name == "weight":
        return 1
    if isinstance(module, (Dense, Conv)) and name == "weight":
        return 0
    return None


def shard_params_tp(model: nn.Module, n_model: int, rank: int) -> TPShards:
    """Model rank `rank`'s share of every parameter and buffer of `model`
    under the rules above; a leaf whose split axis does not divide n_model
    is kept whole."""
    out: TPShards = {}
    for mname, mod in model.named_modules():
        leaves = dict(mod.named_parameters(recurse=False))
        leaves.update(mod.named_buffers(recurse=False))
        for lname, leaf in leaves.items():
            dim = tp_spec(mod, lname)
            if dim is not None and leaf.shape[dim] % n_model:
                dim = None
            t = leaf.detach()
            if dim is not None:
                t = t.chunk(n_model, dim)[rank]
            out[f"{mname}.{lname}" if mname else lname] = (t.contiguous(),
                                                           dim)
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input gradient over the
    model group (each rank's share of the next layer saw the whole
    input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the ranks' output shares along `dim`; the backward
    keeps the rank's own slice (everything after the gather is replicated
    on every model rank)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.n, ctx.rank = dist.get_world_size(group), dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(ctx.n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, ctx.dim)[ctx.rank].contiguous(), None, None


def _gather_param(t: torch.Tensor, dim: Optional[int], group):
    if dim is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def tp_generator_forward(generator, shards: TPShards, z: torch.Tensor,
                         group) -> torch.Tensor:
    """The generator's inference forward (BatchNorm on its running
    statistics) with its layers split over the model `group`: each rank
    computes its share of every linear layer's output channels (bias
    included) and all-gathers them; the BatchNorms run on the gathered
    activations. Differentiable with respect to z (the projection runs
    through it). Returns images [N, H, W, C] in [-1, 1], as the
    generator's forward."""
    dt = generator.dtype

    def split_input(x, name):
        if shards[f"{name}.weight"][1] is None:
            return x
        return _CopyToModel.apply(x, group)

    def gather(y, name, dim):
        if shards[f"{name}.weight"][1] is None:
            return y
        return _GatherFromModel.apply(y, dim, group)

    def w(name):
        return shards[name][0]

    def bn(h, name):
        mod: BatchNorm = getattr(generator, name)
        p = {leaf: _gather_param(*shards[f"{name}.{leaf}"], group)
             for leaf in ("scale", "bias", "mean", "var")}
        return batch_norm(h.float(), p["mean"], p["var"], p["scale"],
                          p["bias"], mod.eps, mod.dtype)

    hw, c0 = generator.base_hw, generator.channels[0]
    x = split_input(z.to(dt), "fc_in")
    h = x @ w("fc_in.weight").to(dt).t() + w("fc_in.bias").to(dt)
    h = gather(h, "fc_in", 1)
    h = h.reshape(h.shape[0], hw, hw, c0).permute(0, 3, 1, 2)
    h = torch.relu(bn(h, "bn_in"))
    names = [f"deconv_{i}" for i in range(len(generator.channels) - 1)]
    for i, name in enumerate(names + ["deconv_out"]):
        mod = getattr(generator, name)
        x = split_input(h.to(dt), name)
        y = conv_transpose_same(x, w(f"{name}.weight"), mod.k, mod.stride) \
            + w(f"{name}.bias").to(dt)[None, :, None, None]
        h = gather(y, name, 1)
        if name != "deconv_out":
            h = torch.relu(bn(h, f"bn_{i}"))
    return torch.tanh(h).to(torch.float32).permute(0, 2, 3, 1)
