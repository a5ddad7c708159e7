"""Weight bridge: flax parameter trees (as numpy) <-> the port's modules.

The JAX package checkpoints with orbax; scripts/export_torch_weights.py
restores a run there and writes the trees to `<run>/export/<step>.npz`,
each array under its flax path ("generator/params/fc_in/kernel", ...).
This module reads such a file and loads the trees into the port's modules,
matching submodules by their flax names; `write_export` is the way back,
so a run the port trains is read exactly as a JAX run is (the generator
with its batch stats, the critic, the encoder). Layout maps:

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
from typing import Dict, Optional, Tuple

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


def dense_kernel(weight: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(weight).T)


def conv_kernel(weight: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(weight).transpose(2, 3, 1, 0))


def conv_transpose_kernel(weight: np.ndarray) -> np.ndarray:
    k = np.asarray(weight).transpose(2, 3, 0, 1)[::-1, ::-1]
    return np.ascontiguousarray(k)


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
    layers = _layers(module)
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


def _layers(module: nn.Module) -> Dict[str, nn.Module]:
    return {name: child for name, child in module.named_children()
            if isinstance(child, (Dense, Conv, ConvTranspose, BatchNorm))}


def flax_tree(module: nn.Module) -> Tuple[Dict, Dict]:
    """The inverse of load_flax_tree: (params, batch_stats) of `module` as
    flax trees of float32 numpy arrays (batch_stats empty when the module
    has no BatchNorm)."""
    def np32(t):          # a copy: never a view of the module's memory
        return t.detach().to("cpu", torch.float32).numpy().copy()
    params: Dict = {}
    stats: Dict = {}
    for name, layer in _layers(module).items():
        if isinstance(layer, BatchNorm):
            params[name] = {"scale": np32(layer.scale),
                            "bias": np32(layer.bias)}
            stats[name] = {"mean": np32(layer.mean), "var": np32(layer.var)}
            continue
        kernel = {Dense: dense_kernel, Conv: conv_kernel,
                  ConvTranspose: conv_transpose_kernel}[type(layer)]
        params[name] = {"kernel": kernel(np32(layer.weight)),
                        "bias": np32(layer.bias)}
    return params, stats


def flatten(tree: Dict, prefix: str) -> Dict[str, np.ndarray]:
    """{'a': {'b': x}} -> {'prefix/a/b': x} (unflatten's inverse)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def write_export(output_dir: str, step: int, modules: Dict[str, nn.Module],
                 manifest: Optional[Dict] = None) -> str:
    """Write `<output_dir>/export/<step>.npz` from the port's modules
    ({'generator': g, 'critic': c, 'encoder': e}, any subset) under flax
    paths, and its side-car manifest `<step>.json` (the step, the array
    shapes and whatever `manifest` adds). Both are written to temporary
    names first, so a reader never sees half a file."""
    arrays: Dict[str, np.ndarray] = {}
    for name, module in modules.items():
        params, stats = flax_tree(module)
        arrays.update(flatten(params, f"{name}/params"))
        arrays.update(flatten(stats, f"{name}/batch_stats"))
    root = os.path.join(output_dir, EXPORT_SUBDIR)
    os.makedirs(root, exist_ok=True)
    base = os.path.join(root, str(int(step)))
    with open(base + ".npz.tmp", "wb") as f:
        np.savez(f, **arrays)
    meta = dict(manifest or {}, step=int(step),
                arrays={k: list(v.shape) for k, v in sorted(arrays.items())})
    with open(base + ".json.tmp", "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(base + ".npz.tmp", base + ".npz")
    os.replace(base + ".json.tmp", base + ".json")
    return base + ".npz"


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
    'critic': {'params'}, 'encoder': {'params'}} (critic and encoder only
    when the run had them), plus 'manifest' when the side-car JSON
    exists."""
    with np.load(path) as z:
        tree = unflatten({k: z[k] for k in z.files})
    manifest = path[:-4] + ".json"
    if os.path.exists(manifest):
        with open(manifest) as f:
            tree["manifest"] = json.load(f)
    return tree
