"""The port's multi-device serving (defensegan_torch/parallel/serving.py::
ShardedDefenseGAN) on a mesh of four CPU shards.

Tolerances:
  - against the port's single-device reconstruct of each shard with the
    shard's generator (generator_for(fold_seed(base, i))) or its slice of
    a given z0: equal, bit for bit;
  - against the JAX package's ShardedDefenseGAN on make_mesh(4)
    (kernel="xla"), the same weights and JAX's per-shard z0 (sample_z0 of
    fold_in(key, shard)) passed in: tests/test_torch_project.py's plain-path
    bounds, all_losses rtol 1e-3 and equal argmins.
"""

import jax
import numpy as np
import pytest
import torch

from defensegan_tpu.configs import Config as JaxConfig
from defensegan_tpu.defense.project import sample_z0 as jax_sample_z0
from defensegan_tpu.gan import DefenseGAN as JaxDefenseGAN
from defensegan_tpu.parallel import ShardedDefenseGAN as JaxSharded
from defensegan_tpu.parallel import make_mesh as jax_make_mesh
from defensegan_torch.ckpt.bridge import load_flax_tree
from defensegan_torch.configs import Config
from defensegan_torch.defense.pipeline import DefendedPipeline
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.parallel import ShardedDefenseGAN, make_mesh
from defensegan_torch.parallel.serving import base_seed
from defensegan_torch.utils.misc import fold_seed, generator_for

torch.set_num_threads(2)

CFG = dict(type="mnist", gen_dim=4, latent_dim=8, disc_dim=4, rec_rr=2,
           rec_iters=5, compute_dtype="float32")
MESH = ["cpu"] * 4


def _gan(seed=0, **kw):
    return DefenseGAN(Config(**dict(CFG, seed=seed, **kw)), device="cpu")


def _x(n=8, seed=0):
    return np.random.RandomState(seed).rand(n, 28, 28, 1).astype(np.float32)


def _per_shard(gan, x, seed, n=4, **kw):
    b = x.shape[0] // n
    return [gan.reconstruct(x[i * b:(i + 1) * b],
                            generator_for(fold_seed(seed, i), "cpu"), **kw)
            for i in range(n)]


def _assert_equal(res, parts):
    for f in range(4):
        assert torch.equal(res[f], torch.cat([p[f] for p in parts])), f


@pytest.mark.parametrize("kernel", ["xla", "packed"])
def test_sharded_equals_per_shard_runs(kernel):
    gan = _gan()
    sharded = ShardedDefenseGAN(gan, make_mesh(devices=MESH))
    x = _x()
    res = sharded.reconstruct(x, torch.Generator().manual_seed(7),
                              kernel=kernel)
    seed = base_seed(torch.Generator().manual_seed(7), gan.cfg)
    _assert_equal(res, _per_shard(gan, x, seed, kernel=kernel))
    assert sharded.last_kernel == kernel and res.x_hat.shape == x.shape
    # gen None: the base seed is cfg.seed + 1, as DefenseGAN's default
    _assert_equal(sharded.reconstruct(x, kernel=kernel),
                  _per_shard(gan, x, gan.cfg.seed + 1, kernel=kernel))


@pytest.mark.parametrize("init", ["encoder", "encoder_jitter"])
def test_sharded_encoder_init_equals_per_shard_runs(init):
    gan = _gan()
    gan._build_encoder()
    sharded = ShardedDefenseGAN(gan, make_mesh(devices=MESH))
    x = _x(seed=3)
    res = sharded.reconstruct(x, kernel="xla", init=init)
    _assert_equal(res, _per_shard(gan, x, gan.cfg.seed + 1, kernel="xla",
                                  init=init))


def test_given_z0_is_split_with_x():
    gan = _gan()
    x = _x(seed=4)
    z0 = torch.randn(8, 2, 8, generator=torch.Generator().manual_seed(1))
    res = ShardedDefenseGAN(gan, make_mesh(devices=MESH)).reconstruct(
        x, z0=z0, kernel="xla")
    _assert_equal(res, [gan.reconstruct(x[2 * i:2 * i + 2],
                                        z0=z0[2 * i:2 * i + 2], kernel="xla")
                        for i in range(4)])
    with pytest.raises(ValueError, match="does not match"):
        ShardedDefenseGAN(gan, make_mesh(devices=MESH)).reconstruct(
            x, z0=z0[:4], kernel="xla")


def test_sharded_matches_jax_sharded(eight_devices):
    jgan = JaxDefenseGAN(JaxConfig(**CFG))
    gan = _gan()
    load_flax_tree(gan.generator,
                   jax.tree.map(np.asarray, jgan.state.gen_params),
                   jax.tree.map(np.asarray, jgan.state.gen_stats))
    x, key = _x(seed=5), jax.random.key(9)
    ref = JaxSharded(jgan, jax_make_mesh(4)).reconstruct(x, key,
                                                         kernel="xla")
    z0 = np.concatenate([np.asarray(jax_sample_z0(
        jax.random.fold_in(key, i), 2, 2, 8)) for i in range(4)])
    got = ShardedDefenseGAN(gan, make_mesh(devices=MESH)).reconstruct(
        x, z0=torch.from_numpy(z0), kernel="xla")
    ref_l = np.asarray(ref.all_losses)
    np.testing.assert_allclose(got.all_losses.numpy(), ref_l, rtol=1e-3)
    np.testing.assert_array_equal(got.all_losses.numpy().argmin(1),
                                  ref_l.argmin(1))


def test_back_prop_and_bad_batch_raise():
    sharded = ShardedDefenseGAN(_gan(), make_mesh(devices=MESH))
    with pytest.raises(ValueError, match="divisible"):
        sharded.reconstruct(np.zeros((6, 28, 28, 1), np.float32))
    with pytest.raises(ValueError, match="serving path"):
        sharded.reconstruct(np.zeros((8, 28, 28, 1), np.float32),
                            back_prop=True)


def test_one_replica_per_device_refreshed_after_load(tmp_path):
    other = _gan(seed=11, output_dir=str(tmp_path))
    other.step = 5
    other.write_export()
    gan = _gan(output_dir=str(tmp_path))
    sharded = ShardedDefenseGAN(gan, make_mesh(devices=MESH))
    x = _x(seed=6)
    stale = sharded.reconstruct(x, kernel="xla").x_hat
    assert len(sharded._replicas) == 1          # four shards, one device
    gan.load()
    fresh = sharded.reconstruct(x, kernel="xla").x_hat
    assert not torch.allclose(fresh, stale)
    assert torch.equal(fresh, ShardedDefenseGAN(
        gan, make_mesh(devices=MESH)).reconstruct(x, kernel="xla").x_hat)
    assert sharded.replica(torch.device("cpu")).step == 5


def test_pipeline_over_sharded_gan():
    """DefendedPipeline(combined, 2 passes, vote) runs unchanged on the
    sharded GAN: per-example outputs of the right shapes, finite."""
    gan = _gan()
    sharded = ShardedDefenseGAN(gan, make_mesh(devices=MESH))
    assert sharded.device == torch.device("cpu")

    def logits_fn(xb):
        m = xb.mean((1, 2, 3))
        return torch.stack([1.0 - m, m], -1)

    x_cal = gan.generate(torch.Generator().manual_seed(1), 16).numpy()
    x = gan.generate(torch.Generator().manual_seed(2), 16).numpy()
    pipe = DefendedPipeline(sharded, logits_fn, fpr=0.25,
                            detector="combined", detect_passes=2, vote=True)
    out = pipe.calibrate(x_cal, batch_size=16).predict(x, batch_size=16)
    assert out.pred.shape == (16,) and out.flagged.shape == (16,)
    assert np.all(np.isfinite(out.rec_err)) and out.flagged.sum() < 16
