"""The weights a cell serves, made or read by the benchmark and handed to
both sides in the flax layout of the repository's weight exports
(`<layer>/<leaf>` paths, float32 tensors on the device).

Seeded weights are drawn on the device from one torch.Generator in two
calls (one normal, one uniform draw for every tensor at once): kernels
LeCun-normal (flax's default init, fan-in the product of all but the last
axis), biases zero, and every BatchNorm's scale, bias and running
statistics drawn around the identity so that its fold is not trivial.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def seeded(shapes: Dict[str, tuple], seed: int,
           device: torch.device) -> Dict[str, torch.Tensor]:
    paths = sorted(shapes)
    sizes = [math.prod(shapes[p]) for p in paths]
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for path, size in zip(paths, sizes):
        shape = shapes[path]
        n = normal[off:off + size].view(shape)
        u = uniform[off:off + size].view(shape)
        off += size
        leaf = path.rsplit("/", 1)[1]
        if leaf == "kernel":
            t = n / math.sqrt(math.prod(shape[:-1]))
        elif path.startswith("bn"):
            t = {"scale": 1.0 + 0.3 * n, "bias": 0.2 * n, "mean": 0.2 * n,
                 "var": 0.5 + u}[leaf]
        else:                                     # a layer's bias
            t = torch.zeros_like(n)
        out[path] = t.contiguous()
    return out


def from_export(path: str, module: str,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """One module's tensors of a weight export (`<module>/params/...` and
    `<module>/batch_stats/...`), by `<layer>/<leaf>`."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            if parts[0] != module:
                continue
            out["/".join(parts[2:])] = torch.as_tensor(
                np.asarray(z[key], np.float32), device=device)
    if not out:
        raise KeyError(f"{path} holds no {module!r} weights")
    return out


def check_shapes(tree: Dict[str, torch.Tensor],
                 shapes: Dict[str, tuple]) -> None:
    got = {p: tuple(t.shape) for p, t in tree.items()}
    if got != {p: tuple(s) for p, s in shapes.items()}:
        raise ValueError(f"weights {got} do not have the configuration's "
                         f"shapes {shapes}")
