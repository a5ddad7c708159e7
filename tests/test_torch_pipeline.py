"""PyTorch port vs JAX: classifiers A-F, the encoder and its z0 policies,
batched reconstruction and DefendedPipeline (defensegan_torch/models/,
defense/encoder_init.py, eval/, defense/pipeline.py).

Same weights (JAX inits, bridged) and the same random draws: the JAX
pipeline draws each batch's z0 from a split of its key, and the port is
handed exactly those draws through z0_fn. float32 throughout; tolerances
are float32 summation order (1e-4 on logits of these small nets, 1e-3
relative on losses carried through the momentum-GD loop, 1e-2 relative
on the restart dispersion, a ratio of loss differences that magnifies
theirs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.configs import Config as JaxConfig
from defensegan_tpu.defense.encoder_init import encoder_z0 as jax_encoder_z0
from defensegan_tpu.defense.pipeline import DefendedPipeline as JaxPipeline
from defensegan_tpu.gan import DefenseGAN as JaxGAN
from defensegan_tpu.models.classifiers import build_classifier as jax_clf
from defensegan_tpu.models.encoder import encoder_for as jax_encoder_for
from defensegan_torch.ckpt.bridge import load_flax_tree, read_export
from defensegan_torch.configs import Config
from defensegan_torch.defense.encoder_init import encoder_z0
from defensegan_torch.defense.pipeline import DefendedPipeline
from defensegan_torch.eval.accuracy import batched_reconstruct
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.models import build_classifier, encoder_for

torch.set_num_threads(2)

LATENT, RR, ITERS, BATCH = 16, 2, 4, 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", list("ABCDEF"))
def test_classifier_matches_jax(name):
    jc = jax_clf(name)
    x = np.random.RandomState(0).rand(2, 28, 28, 1).astype(np.float32)
    params = _np_tree(jc.init(jax.random.key(1), jnp.asarray(x))["params"])
    ref = np.asarray(jc.apply({"params": params}, x))
    tc = build_classifier(name)
    load_flax_tree(tc, params)
    with torch.no_grad():
        got = tc(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 10)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_flagship_encoder_and_z0_policies_match_jax():
    tree = read_export("output/gans/mnist_fast/export/20000.npz")
    params = tree["encoder"]["params"]
    je = jax_encoder_for("mnist", 64, z_dim=128)
    te = encoder_for("mnist", 64, z_dim=128)
    load_flax_tree(te, params)
    rng = np.random.RandomState(2)
    x = rng.rand(3, 28, 28, 1).astype(np.float32)
    key = jax.random.key(5)
    noise = np.asarray(jax.random.normal(key, (3, RR + 1, 128)))

    def jenc(x_tanh):
        return je.apply({"params": params}, x_tanh)
    for mode in ("encoder", "encoder_jitter"):
        ref = np.asarray(jax_encoder_z0(jenc, jnp.asarray(x), key,
                                        rec_rr=RR + 2, mode=mode))
        with torch.no_grad():
            got = encoder_z0(te, torch.from_numpy(x), None, rec_rr=RR + 2,
                             mode=mode, noise=torch.tensor(noise)).numpy()
        assert got.shape == (3, RR + 2, 128)
        np.testing.assert_allclose(got, ref, atol=1e-4)
    with pytest.raises(ValueError):
        encoder_z0(te, torch.from_numpy(x), None, rec_rr=2, mode="random")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX DefenseGAN and the port's, same random weights, plus a
    classifier E each."""
    out = str(tmp_path_factory.mktemp("run"))
    kw = dict(type="mnist", gen_arch="wide", gen_dim=4, disc_dim=4,
              latent_dim=LATENT, rec_rr=RR, rec_iters=ITERS,
              compute_dtype="float32", output_dir=out)
    jgan = JaxGAN(JaxConfig(**kw))
    tgan = DefenseGAN(Config(**kw), device="cpu")
    load_flax_tree(tgan.generator, _np_tree(jgan.state.gen_params),
                   _np_tree(jgan.state.gen_stats))
    jc = jax_clf("E")
    cparams = _np_tree(jc.init(jax.random.key(3),
                               jnp.zeros((1, 28, 28, 1)))["params"])
    tc = build_classifier("E")
    load_flax_tree(tc, cparams)
    return (jgan, lambda x: jc.apply({"params": cparams}, x),
            tgan, tc.requires_grad_(False))


def _jax_draws(key, p, n):
    """The z0 the JAX pipeline draws for pass p at batch offset lo
    (eval/accuracy.py::batched_reconstruct key splits; pass p > 0 folds
    p into the key, defense/pipeline.py)."""
    key = key if p == 0 else jax.random.fold_in(key, p)
    draws = {}
    for lo in range(0, n, BATCH):
        key, k = jax.random.split(key)
        draws[lo] = torch.from_numpy(np.array(
            jax.random.normal(k, (BATCH, RR, LATENT))))
    return draws


def test_batched_reconstruct_pads_and_replays(pair):
    _, _, tgan, _ = pair
    x = np.random.RandomState(4).rand(6, 28, 28, 1).astype(np.float32)
    draws = _jax_draws(jax.random.key(0), 0, 6)
    seen = []
    for res, lo, hi in batched_reconstruct(tgan, x, batch_size=BATCH,
                                           z0_fn=draws.__getitem__):
        seen.append((lo, hi))
        assert res.x_hat.shape == (BATCH, 28, 28, 1)
        assert res.all_losses.shape == (BATCH, RR)
        direct = tgan.reconstruct(
            torch.cat([torch.from_numpy(x[lo:hi]),
                       torch.zeros(BATCH - (hi - lo), 28, 28, 1)]),
            z0=draws[lo])
        torch.testing.assert_close(res.all_losses, direct.all_losses)
    assert seen == [(0, 4), (4, 6)]


@pytest.mark.parametrize("detector,passes,vote", [
    ("two_sided", 1, False), ("one_sided", 1, False),
    ("combined", 1, False), ("combined3", 1, False), ("margin", 1, False),
    ("two_sided", 2, True)])
def test_pipeline_matches_jax(pair, detector, passes, vote):
    jgan, jlogits, tgan, tclf = pair
    rng = np.random.RandomState(5)
    x_cal = rng.rand(8, 28, 28, 1).astype(np.float32)
    x = np.concatenate([x_cal[:3], rng.rand(3, 28, 28, 1)]).astype(
        np.float32)
    kc, kp = jax.random.key(10), jax.random.key(11)
    jp = JaxPipeline(jgan, jlogits, detector=detector,
                     detect_passes=passes, vote=vote)
    jp.calibrate(x_cal, kc, batch_size=BATCH)
    ref = jp.predict(x, kp, batch_size=BATCH)

    cal = {p: _jax_draws(kc, p, 8) for p in range(passes)}
    req = {p: _jax_draws(kp, p, 6) for p in range(passes)}
    tp = DefendedPipeline(tgan, tclf, detector=detector,
                          detect_passes=passes, vote=vote)
    tp.calibrate(x_cal, batch_size=BATCH,
                 z0_fn=lambda p, lo: cal[p][lo])
    got = tp.predict(x, batch_size=BATCH, z0_fn=lambda p, lo: req[p][lo])
    np.testing.assert_array_equal(got.pred, ref.pred)
    np.testing.assert_allclose(got.rec_err, ref.rec_err, rtol=1e-3)
    np.testing.assert_allclose(got.margin, ref.margin, atol=1e-3)
    np.testing.assert_allclose(got.dispersion, ref.dispersion, rtol=1e-2,
                               atol=1e-4)
    np.testing.assert_array_equal(got.flagged, ref.flagged)
    assert got.pred.dtype == np.int32 and got.flagged.dtype == bool


def test_pipeline_guards(pair):
    _, _, tgan, tclf = pair
    with pytest.raises(ValueError):
        DefendedPipeline(tgan, tclf, detector="nope")
    with pytest.raises(ValueError):
        DefendedPipeline(tgan, tclf, vote=True)
    with pytest.raises(RuntimeError, match="calibrate"):
        DefendedPipeline(tgan, tclf).predict(np.zeros((1, 28, 28, 1),
                                                      np.float32))
