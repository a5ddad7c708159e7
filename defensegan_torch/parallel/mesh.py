"""1-D data-parallel mesh of torch devices (port of the JAX package's
parallel/mesh.py).

Defense-GAN's workloads (WGAN training, the R x L projection, attack
evaluations) are data-parallel over the image batch: weights are
replicated, batches are split on their leading axis. A mesh here is a
tuple of `torch.device`s, one per shard, in shard order; a device may
appear more than once (two shards on one card). Multi-process training
places one process on each device and uses torch.distributed instead
(parallel/distributed.py).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"

Mesh = Tuple[torch.device, ...]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D (data,) mesh over the first n (default: all) devices.

    devices defaults to every CUDA device; without one it raises: pass
    `devices` (for instance ["cpu"] * 4) to build a mesh on the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the mesh spans the GPUs; "
                               "pass devices=[...] explicitly for a mesh "
                               "of CPU shards")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if n_devices is not None and n_devices > 0:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return devices


def validate_batch_for_mesh(mesh: Mesh, batch: int,
                            what: str = "batch") -> None:
    """Fail informatively when a leading axis can't shard evenly."""
    n = len(mesh)
    if batch % n != 0:
        raise ValueError(
            f"{what}={batch} is not divisible by the {n}-device "
            f"'{DATA_AXIS}' mesh (remainder {batch % n}); pad the batch "
            f"(eval/accuracy.py pads+masks this way) or choose a multiple "
            f"of {n}")


def validate_projection_sharding(mesh: Mesh, batch: int,
                                 rec_rr: int) -> None:
    """Projection sharding contract: shard the IMAGE batch axis, never the
    flattened batch*R axis, so each shard owns whole restart groups and the
    per-image argmin over R never crosses shards. batch % n_devices == 0
    guarantees that for any R (restarts ride inside each image's shard)."""
    validate_batch_for_mesh(mesh, batch, what="projection batch")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def shard_batch(mesh: Mesh, batch) -> list:
    """Split a tensor (or a dict / list / tuple tree of tensors and numpy
    arrays) on axis 0 into len(mesh) equal chunks: returns one tree per
    shard, chunk i on mesh[i]. 0-d leaves have no batch axis and are
    replicated to every shard."""
    for a in _leaves(batch):
        if torch.as_tensor(a).ndim > 0:
            validate_batch_for_mesh(mesh, torch.as_tensor(a).shape[0])

    def chunk(i, dev):
        def take(a):
            t = torch.as_tensor(a)
            if t.ndim == 0:
                return t.to(dev)
            b = t.shape[0] // len(mesh)
            return t[i * b:(i + 1) * b].to(dev)
        return take
    return [_tree_map(chunk(i, dev), batch) for i, dev in enumerate(mesh)]
