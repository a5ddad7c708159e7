"""PyTorch port vs JAX: packed generators (defensegan_torch/defense/
fastgen.py).

The packs are host arithmetic on the same float32 weights, so w_fc, b_fc
and the probed dense D must EQUAL the JAX package's, bit for bit (both in
float32 and rounded to bfloat16). The packed applies must equal G(z) to
float32 summation-order tolerance, 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.defense import fastgen as jfast
from defensegan_tpu.models.generator import generator_for as jax_generator
from defensegan_torch.ckpt.bridge import load_flax_tree, read_export
from defensegan_torch.defense.fastgen import make_packed_apply, \
    pack_generator
from defensegan_torch.models.generator import generator_for

torch.set_num_threads(2)


def _pair(arch, dtype="float32", dim=4, latent=16, seed=0):
    jg = jax_generator("mnist", dim, getattr(jnp, dtype), arch)
    v = jg.init(jax.random.key(seed), jnp.zeros((1, latent)))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.randn(
        *a.shape).astype(np.float32), v["params"])
    stats = jax.tree.map(lambda a: np.asarray(a) + 0.5 * rng.rand(
        *a.shape).astype(np.float32), v["batch_stats"])
    tg = generator_for("mnist", dim, getattr(torch, dtype), arch, latent)
    load_flax_tree(tg, params, stats)
    return jg, params, stats, tg.requires_grad_(False)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_pack_equals_jax(dtype):
    jg, params, stats, tg = _pair("wide", dtype)
    jp = jfast.pack_generator(jg, params, stats, variant="dense")
    tp = pack_generator(tg, "dense")
    assert tp.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(tp.w_fc), np.asarray(jp.w_fc,
                                                           np.float32))
    np.testing.assert_array_equal(_np(tp.b_fc), np.asarray(jp.b_fc,
                                                           np.float32))
    for got, ref in zip(tp.dense, jp.dense):
        np.testing.assert_array_equal(_np(got), np.asarray(ref, np.float32))


def test_flagship_dense_pack_equals_jax():
    tree = read_export("output/gans/mnist_fast/export/20000.npz")
    p, s = tree["generator"]["params"], tree["generator"]["batch_stats"]
    jg = jax_generator("mnist", 16, jnp.bfloat16, "wide")
    jp = jfast.pack_generator(jg, p, s, variant="dense")
    tg = generator_for("mnist", 16, torch.bfloat16, "wide", 128)
    load_flax_tree(tg, p, s)
    tp = pack_generator(tg, "dense")
    assert tuple(tp.dense[0].shape) == (6272, 784)
    np.testing.assert_array_equal(_np(tp.dense[0]),
                                  np.asarray(jp.dense[0], np.float32))
    np.testing.assert_array_equal(_np(tp.w_fc),
                                  np.asarray(jp.w_fc, np.float32))


@pytest.mark.parametrize("arch,variant", [("wide", "dense"), ("wide", "conv"),
                                          ("deep", "conv")])
def test_packed_apply_equals_generator(arch, variant):
    jg, params, stats, tg = _pair(arch)
    z = np.random.RandomState(1).randn(4, 16).astype(np.float32)
    ref = np.asarray(jg.apply({"params": params, "batch_stats": stats}, z,
                              train=False)).reshape(4, -1)
    apply_flat = make_packed_apply(pack_generator(tg, variant))
    got = apply_flat(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    jref = np.asarray(jfast.make_packed_apply(jfast.pack_generator(
        jg, params, stats, variant=variant))(jnp.asarray(z)))
    np.testing.assert_allclose(got, jref, atol=1e-5)


def test_bf16_dense_apply_matches_jax():
    """The dense apply's epilogue runs in the compute dtype (bf16 for the
    flagship) and rounds after each product, bias add and tanh, as JAX's
    does: one bf16 ulp (2^-8) tolerance for summation-order rounding."""
    jg, params, stats, tg = _pair("wide", "bfloat16")
    z = np.random.RandomState(2).randn(8, 16).astype(np.float32)
    jref = np.asarray(jfast.make_packed_apply(jfast.pack_generator(
        jg, params, stats, variant="dense"))(jnp.asarray(z)))
    got = make_packed_apply(pack_generator(tg, "dense"))(
        torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, jref, atol=2.0 ** -8)


def test_unported_variants_raise():
    _, _, _, tg = _pair("deep")
    for variant in ("s2d", "phase", "hybrid"):
        with pytest.raises(ValueError, match="not ported"):
            pack_generator(tg, variant)
    with pytest.raises(ValueError, match="single-deconv"):
        pack_generator(tg, "dense")
