"""The port's tensor-parallel channel split (defensegan_torch/parallel/
tp.py) on four gloo ranks on the CPU, a (data 2, model 2) mesh: the
generator forward and the R x L projection through it against the
replicated ones.

The ranks are spawned once for the module (tests/torch_parallel_workers.py
::tp_ranks). Weights: the deep MNIST generator at GEN_DIM 16, LATENT_DIM
32 (channels divide the 2-wide model axis; the 1-channel output deconv
stays replicated), flax-initialized, float32; 8 latents, and 8 images at
R 2, L 5.

Tolerances: the split forward and projection against the port's
replicated ones within the JAX package's tests/test_parallel_tp.py bounds
(rtol 5e-5 / atol 5e-6; projection loss rtol 5e-5 / atol 5e-7: the split
reorders only the all-gathers, not a sum); the split forward against
JAX's replicated forward within the same bounds; the split projection
against JAX's within tests/test_torch_project.py's (all_losses rtol 1e-3,
equal argmins: float32 summation order of the two frameworks, carried by
L steps at lr 10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.defense.project import reconstruct as jax_reconstruct
from defensegan_tpu.defense.project import sample_z0 as jax_sample_z0
from defensegan_tpu.models import generator_for as jax_generator_for
from defensegan_torch.ckpt.bridge import load_flax_tree
from defensegan_torch.defense.project import reconstruct
from defensegan_torch.models import generator_for
from defensegan_torch.models.layers import (BatchNorm, Conv, ConvTranspose,
                                            Dense)
from defensegan_torch.parallel import (MODEL_AXIS, make_mesh_2d,
                                       shard_params_tp, spawn_group, tp_spec)
from torch_parallel_workers import tp_ranks

DIM, K, B, RR, L = 16, 32, 8, 2, 5
N_DATA, WORLD = 2, 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs():
    jg = jax_generator_for("mnist", DIM)
    v = jg.init(jax.random.key(0), jnp.zeros((1, K)), train=True)
    params, stats = _np(v["params"]), _np(v["batch_stats"])

    def japply(z):
        return jg.apply({"params": params, "batch_stats": stats}, z,
                        train=False)
    z = np.array(jax.random.normal(jax.random.key(1), (B, K)))
    x = np.array(jax.random.uniform(jax.random.key(2), (B, 28, 28, 1)))
    z0 = np.array(jax_sample_z0(jax.random.key(3), B, RR, K))
    jax_ref = dict(forward=np.asarray(japply(z)),
                   proj=jax_reconstruct(japply, jnp.asarray(x),
                                        jnp.asarray(z0), rec_iters=L))
    gen = load_flax_tree(generator_for("mnist", DIM, latent_dim=K), params,
                         stats).requires_grad_(False)
    with torch.no_grad():
        fwd = gen(torch.from_numpy(z)).numpy()
    port_ref = dict(forward=fwd, proj=reconstruct(
        gen, torch.from_numpy(x), torch.from_numpy(z0), rec_iters=L))
    trees = dict(dim=DIM, params=params, stats=stats)
    ranks = spawn_group(tp_ranks, WORLD, device="cpu",
                        args=(trees, K, N_DATA, z, x, z0, L), timeout=300)
    return ranks, port_ref, jax_ref


def _rows(r, a):
    b = a.shape[0] // N_DATA
    return np.asarray(a)[r["data_rank"] * b:(r["data_rank"] + 1) * b]


def test_tp_spec_rules():
    dense, conv, convt, bn = Dense(3, 8), Conv(2, 8, 3), \
        ConvTranspose(8, 4), BatchNorm(8)
    assert tp_spec(dense, "weight") == 0 and tp_spec(dense, "bias") == 0
    assert tp_spec(conv, "weight") == 0
    assert tp_spec(convt, "weight") == 1 and tp_spec(convt, "bias") == 0
    assert all(tp_spec(bn, n) == 0 for n in ("scale", "bias", "mean", "var"))
    conv.register_buffer("table", torch.zeros(2, 2))
    assert tp_spec(conv, "table") is None
    assert MODEL_AXIS == "model"


def test_tp_odd_channels_fall_back_to_replicated():
    """A leaf whose split axis doesn't divide the model axis stays whole."""
    odd = shard_params_tp(BatchNorm(7), 2, 1)
    assert all(d is None and tuple(t.shape) == (7,)
               for t, d in odd.values())
    dense = Dense(3, 6)
    even = shard_params_tp(dense, 2, 1)
    assert even["weight"][1] == 0
    assert torch.equal(even["weight"][0], dense.weight.detach()[3:])


def test_make_mesh_2d_needs_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh_2d(2, 2)


def test_tp_ranks_hold_their_shares(runs):
    ranks, _, _ = runs
    assert sorted((r["data_rank"], r["model_rank"]) for r in ranks) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        assert r["split"]["deconv_out.weight"] is None      # 1 channel
        assert r["split"]["deconv_0.weight"] == 1
        assert r["local_shapes"]["deconv_0.weight"] == (2 * DIM, DIM // 2,
                                                        5, 5)
        assert r["split"]["fc_in.weight"] == 0
        assert r["local_shapes"]["bn_in.mean"] == (DIM,)


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_tp_forward_matches_replicated(runs, ref):
    ranks, port_ref, jax_ref = runs
    want = (port_ref if ref == "port" else jax_ref)["forward"]
    for r in ranks:
        np.testing.assert_allclose(r["forward"], _rows(r, want), rtol=5e-5,
                                   atol=5e-6)


def test_tp_projection_matches_replicated(runs):
    ranks, port_ref, _ = runs
    p = port_ref["proj"]
    for r in ranks:
        np.testing.assert_allclose(r["x_hat"], _rows(r, p.x_hat.numpy()),
                                   rtol=5e-5, atol=5e-6)
        np.testing.assert_allclose(r["loss"], _rows(r, p.loss.numpy()),
                                   rtol=5e-5, atol=5e-7)


def test_tp_projection_matches_jax(runs):
    ranks, _, jax_ref = runs
    p = jax_ref["proj"]
    for r in ranks:
        ref = _rows(r, p.all_losses)
        np.testing.assert_allclose(r["all_losses"], ref, rtol=1e-3)
        np.testing.assert_array_equal(r["all_losses"].argmin(1),
                                      ref.argmin(1))
