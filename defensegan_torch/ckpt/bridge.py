"""Weight bridge: flax parameter trees (as numpy) -> the port's modules.

The JAX package checkpoints with orbax; scripts/export_torch_weights.py
restores a run there and writes the trees to `<run>/export/<step>.npz`,
each array under its flax path ("generator/params/fc_in/kernel", ...).
This module reads such a file and loads the trees into the port's modules,
matching submodules by their flax names. Layout maps:

  Dense          kernel [in, out]     -> weight [out, in]
  Conv           kernel HWIO          -> weight OIHW
  ConvTranspose  kernel HWIO          -> weight [in, out, kh, kw], flipped
                                         in both spatial axes (layers.py)
  BatchNorm      scale, bias (params) + mean, var (batch_stats)

The tests use the same functions on trees of a JAX random init.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from defensegan_torch.models.layers import BatchNorm, Conv, ConvTranspose, \
    Dense

EXPORT_SUBDIR = "export"


def dense_weight(kernel: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(kernel).T)


def conv_weight(kernel: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(kernel).transpose(3, 2, 0, 1))


def conv_transpose_weight(kernel: np.ndarray) -> np.ndarray:
    k = np.asarray(kernel)[::-1, ::-1]
    return np.ascontiguousarray(k.transpose(2, 3, 0, 1))


def _set(t: torch.Tensor, value: np.ndarray) -> None:
    v = torch.as_tensor(np.array(value, np.float32))
    if tuple(v.shape) != tuple(t.shape):
        raise ValueError(f"shape mismatch: flax {tuple(v.shape)} vs "
                         f"port {tuple(t.shape)}")
    with torch.no_grad():
        t.copy_(v.to(t.device))


def load_flax_tree(module: nn.Module, params: Dict,
                   batch_stats: Optional[Dict] = None) -> nn.Module:
    """Load a flax `params` (+ `batch_stats`) tree into `module` in place.

    Every flax submodule must have a port submodule of the same name and
    kind, and every port layer must be covered: a missing or extra name
    raises instead of leaving a layer at its random init.
    """
    batch_stats = batch_stats or {}
    layers = {name: child for name, child in module.named_children()
              if isinstance(child, (Dense, Conv, ConvTranspose, BatchNorm))}
    if set(layers) != set(params):
        raise KeyError(f"flax tree {sorted(params)} does not match port "
                       f"layers {sorted(layers)}")
    for name, layer in layers.items():
        p = params[name]
        if isinstance(layer, BatchNorm):
            _set(layer.scale, p["scale"])
            _set(layer.bias, p["bias"])
            _set(layer.mean, batch_stats[name]["mean"])
            _set(layer.var, batch_stats[name]["var"])
            continue
        conv = {Dense: dense_weight, Conv: conv_weight,
                ConvTranspose: conv_transpose_weight}[type(layer)]
        _set(layer.weight, conv(p["kernel"]))
        _set(layer.bias, p["bias"])
    return module


def unflatten(arrays: Dict[str, np.ndarray]) -> Dict:
    """{'a/b/c': x} -> {'a': {'b': {'c': x}}}."""
    tree: Dict = {}
    for path, value in arrays.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def export_path(output_dir: str, step: Optional[int] = None) -> str:
    """<output_dir>/export/<step>.npz; step None picks the latest."""
    root = os.path.join(output_dir, EXPORT_SUBDIR)
    if step is None:
        steps = [int(os.path.basename(p)[:-4])
                 for p in glob.glob(os.path.join(root, "*.npz"))
                 if os.path.basename(p)[:-4].isdigit()]
        if not steps:
            raise FileNotFoundError(
                f"no weight export under {root} (make one with "
                f"scripts/export_torch_weights.py)")
        step = max(steps)
    return os.path.join(root, f"{step}.npz")


def read_export(path: str) -> Dict:
    """The export's tree: {'generator': {'params', 'batch_stats'},
    'encoder': {'params'}} (encoder only when the run had one), plus
    'manifest' when the side-car JSON exists."""
    with np.load(path) as z:
        tree = unflatten({k: z[k] for k in z.files})
    manifest = path[:-4] + ".json"
    if os.path.exists(manifest):
        with open(manifest) as f:
            tree["manifest"] = json.load(f)
    return tree
