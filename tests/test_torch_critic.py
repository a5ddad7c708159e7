"""PyTorch port vs JAX: the WGAN critic (defensegan_torch/models/
critic.py), BatchNorm's training mode (models/layers.py) and the
generator's (models/generator.py), on the CPU.

  - the critic of the MNIST family (d, 2d) and of the 64x64 family
    (d, 2d, 4d, 8d), loaded from the same flax weights through
    ckpt/bridge.py: float32 scores within rtol 1e-5 / atol 1e-6
    (float32 summation order), bfloat16 within atol 2e-2 of flax's
    bfloat16 scores (a few bf16 ulps of rounding order);
  - BatchNorm in training mode against flax.linen.BatchNorm
    (use_running_average=False, mutable batch_stats): output within 2e-6,
    the updated running mean and biased variance within 1e-7 (float32
    summation order), in float32 and bfloat16 compute;
  - the generator in training mode against flax's apply(train=True,
    mutable=["batch_stats"]): images and running statistics;
  - the bridge's way back: flax_tree inverts load_flax_tree exactly, for
    the generator, the critic and the encoder.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.models import critic_for as jax_critic_for
from defensegan_tpu.models import generator_for as jax_generator_for
from defensegan_torch.ckpt.bridge import flax_tree, load_flax_tree
from defensegan_torch.models import critic_for, encoder_for, generator_for
from defensegan_torch.models.layers import BatchNorm

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dataset,shape", [("mnist", (28, 28, 1)),
                                           ("celeba", (64, 64, 3))])
def test_critic_forward_matches_flax(dataset, shape, dtype):
    jdt, tdt = DTYPES[dtype]
    jc = jax_critic_for(dataset, 4, dtype=jdt)
    x = np.random.RandomState(0).uniform(-1, 1, (8,) + shape) \
        .astype(np.float32)
    params = _np(jax.jit(jc.init)(jax.random.key(1),
                                  jnp.asarray(x[:1]))["params"])
    tc = load_flax_tree(critic_for(dataset, 4, dtype=tdt), params)
    ref = np.asarray(jax.jit(jc.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tc(torch.from_numpy(x)).numpy()
    assert got.shape == (8,) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, ref, atol=2e-2)
    # gradients flow to the input through the compute-dtype cast
    xt = torch.from_numpy(x).requires_grad_(True)
    tc(xt).sum().backward()
    assert xt.grad is not None and torch.isfinite(xt.grad).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_flax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(2)
    x = (rng.randn(8, 5, 5, 6) * 3.0 + 1.5).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, dtype=jdt)
    v = bn.init(jax.random.key(0), jnp.asarray(x))
    stats0 = {"mean": rng.randn(6).astype(np.float32),
              "var": rng.rand(6).astype(np.float32) + 0.5}
    params = {"scale": rng.rand(6).astype(np.float32) + 0.5,
              "bias": rng.randn(6).astype(np.float32)}
    xj = jnp.asarray(x).astype(jdt)
    ref, upd = bn.apply({"params": params, "batch_stats": stats0}, xj,
                        mutable=["batch_stats"])
    tb = BatchNorm(6, dtype=tdt)
    with torch.no_grad():
        tb.scale.copy_(torch.from_numpy(params["scale"]))
        tb.bias.copy_(torch.from_numpy(params["bias"]))
        tb.mean.copy_(torch.from_numpy(stats0["mean"]))
        tb.var.copy_(torch.from_numpy(stats0["var"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt)
    # training mode without the update leaves the statistics alone
    with torch.no_grad():
        tb(xt, train=True)
    np.testing.assert_array_equal(tb.mean.numpy(), stats0["mean"])
    np.testing.assert_array_equal(tb.var.numpy(), stats0["var"])
    with torch.no_grad():
        got = tb(xt, train=True, update_stats=True)
    got = got.float().permute(0, 2, 3, 1).numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-6)
    else:
        # both round the same float32 value to bf16: equal but where the
        # float32 values straddle a rounding boundary (one bf16 ulp)
        assert np.mean(got == ref) > 0.99
        np.testing.assert_allclose(got, ref, rtol=8e-3, atol=1e-2)
    new = _np(upd["batch_stats"])
    np.testing.assert_allclose(tb.mean.numpy(), new["mean"], atol=1e-7)
    np.testing.assert_allclose(tb.var.numpy(), new["var"], atol=1e-7,
                               rtol=1e-6)
    # the running variance is the BIASED batch variance (not torch's
    # unbiased one), folded with momentum 0.99
    xv = x.reshape(-1, 6).astype(np.float64) if dtype == "float32" else \
        np.asarray(xj.astype(jnp.float32)).reshape(-1, 6)
    np.testing.assert_allclose(
        tb.var.numpy(), 0.99 * stats0["var"] + 0.01 * xv.var(0), rtol=1e-5)
    # the inference mode reads the running statistics
    assert v["batch_stats"]["mean"].shape == (6,)


@pytest.mark.parametrize("arch", ["deep", "wide"])
def test_generator_train_mode_matches_flax(arch):
    jg = jax_generator_for("mnist", 4, arch=arch)
    z = np.random.RandomState(3).randn(8, 16).astype(np.float32)
    v = jax.jit(lambda k, zz: jg.init(k, zz, train=True))(
        jax.random.key(4), jnp.asarray(z))
    params, stats = _np(v["params"]), _np(v["batch_stats"])
    ref, upd = jax.jit(lambda vv, zz: jg.apply(
        vv, zz, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(z))
    tg = load_flax_tree(generator_for("mnist", 4, arch=arch, latent_dim=16),
                        params, stats)
    with torch.no_grad():
        got = tg(torch.from_numpy(z), train=True, update_stats=True).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-6)
    new_params, new_stats = flax_tree(tg)
    for name, s in _np(upd["batch_stats"]).items():
        np.testing.assert_allclose(new_stats[name]["mean"], s["mean"],
                                   atol=1e-7)
        np.testing.assert_allclose(new_stats[name]["var"], s["var"],
                                   atol=1e-7, rtol=1e-6)
    # inference mode (the default) stays the running-average forward
    infer = jax.jit(jg.apply)(
        {"params": params, "batch_stats": upd["batch_stats"]},
        jnp.asarray(z))
    with torch.no_grad():
        np.testing.assert_allclose(tg(torch.from_numpy(z)).numpy(),
                                   np.asarray(infer), atol=2e-6)


@pytest.mark.parametrize("dataset", ["mnist", "celeba"])
def test_flax_tree_inverts_load_flax_tree(dataset):
    """flax_tree is load_flax_tree's exact inverse (whose layouts
    test_torch_bridge.py holds against flax): a seeded module's tree loads
    into a differently seeded one and gives back the same tree."""
    def build(seed):
        gen = torch.Generator().manual_seed(seed)
        mods = [generator_for(dataset, 2, arch="deep", latent_dim=8,
                              gen=gen),
                critic_for(dataset, 2, gen=gen),
                encoder_for(dataset, 2, z_dim=8, gen=gen)]
        with torch.no_grad():
            for m in mods:
                for name, buf in m.named_buffers():
                    buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
        return mods
    for src, dst in zip(build(0), build(1)):
        params, stats = flax_tree(src)
        load_flax_tree(dst, params, stats)
        for (k, a), (_, b) in zip(src.state_dict().items(),
                                  dst.state_dict().items()):
            assert torch.equal(a, b), k
        back_p, back_s = flax_tree(dst)
        assert jax.tree.structure(back_p) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(back_p) + jax.tree.leaves(back_s),
                        jax.tree.leaves(params) + jax.tree.leaves(stats)):
            np.testing.assert_array_equal(a, b)
