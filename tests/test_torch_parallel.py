"""The port's device mesh (defensegan_torch/parallel/mesh.py) against the
JAX package's parallel/mesh.py on the CPU: mesh construction, the
batch-sharding contract and its messages (equal strings), and shard_batch
(the same chunks as JAX's shards, 0-d leaves replicated)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.parallel import make_mesh as jax_make_mesh
from defensegan_tpu.parallel import shard_batch as jax_shard_batch
from defensegan_tpu.parallel import validate_batch_for_mesh as jax_vbm
from defensegan_tpu.parallel import validate_projection_sharding as jax_vps
from defensegan_torch.parallel import (DATA_AXIS, make_mesh, shard_batch,
                                       validate_batch_for_mesh,
                                       validate_projection_sharding)

CPU8 = ["cpu"] * 8


def test_make_mesh(eight_devices):
    mesh = make_mesh(devices=CPU8)
    assert len(mesh) == len(jax_make_mesh().devices) == 8
    assert mesh == (torch.device("cpu"),) * 8
    assert len(make_mesh(4, devices=CPU8)) == jax_make_mesh(4).shape[
        DATA_AXIS] == 4
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        make_mesh(9, devices=CPU8)


def test_make_mesh_without_cuda_raises(monkeypatch):
    """The default mesh is every GPU; no quiet fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


@pytest.mark.parametrize("n,batch", [(8, 12), (4, 6), (8, 7), (3, 10)])
def test_validation_messages_are_jax(eight_devices, n, batch):
    mesh, jmesh = make_mesh(n, devices=CPU8), jax_make_mesh(n)
    for ours, theirs, args in (
            (validate_batch_for_mesh, jax_vbm, (batch,)),
            (validate_projection_sharding, jax_vps, (batch, 3))):
        with pytest.raises(ValueError) as jerr:
            theirs(jmesh, *args)
        with pytest.raises(ValueError) as err:
            ours(mesh, *args)
        assert str(err.value) == str(jerr.value)
        assert "divisible" in str(err.value)
    validate_projection_sharding(mesh, 3 * n, 3)     # any R rides along


def test_shard_batch_matches_jax(eight_devices):
    rng = np.random.RandomState(0)
    tree = {"x": rng.rand(16, 4).astype(np.float32),
            "y": np.arange(16, dtype=np.int32),
            "t": (rng.rand(16, 2, 3).astype(np.float32),)}
    shards = shard_batch(make_mesh(devices=CPU8), tree)
    jsh = jax_shard_batch(jax_make_mesh(), jax.tree.map(jnp.asarray, tree))
    assert len(shards) == 8
    for name, got in (("x", [s["x"] for s in shards]),
                      ("y", [s["y"] for s in shards])):
        ref = sorted(jsh[name].addressable_shards, key=lambda s: s.index)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b.data))
    np.testing.assert_array_equal(
        torch.cat([s["t"][0] for s in shards]).numpy(), tree["t"][0])


def test_shard_batch_replicates_scalars_and_validates():
    mesh = make_mesh(devices=["cpu"] * 4)
    out = shard_batch(mesh, {"x": torch.zeros(8, 2), "lr": torch.tensor(3.)})
    assert all(s["lr"].item() == 3.0 and s["x"].shape == (2, 2)
               for s in out)
    with pytest.raises(ValueError, match="divisible"):
        shard_batch(mesh, {"x": torch.zeros(6, 2)})
