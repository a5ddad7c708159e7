"""PyTorch port vs JAX: detection by reconstruction error
(defensegan_torch/eval/detect.py) and the accuracy evaluations
(eval/accuracy.py) on the CPU.

The numpy functions get the same arrays on both sides and must return
equal results (they are the port's own copies; bootstrap and calibration
sweeps share numpy's seeded generator). The projection-backed functions
(reconstruction_errors, detection_features, model_eval_gan) run a tiny
defense (GEN_DIM 4, float32, R 2, L 4) with the same weights and, per
batch, the same z0 (JAX's draws, passed to the port): rtol 1e-3 on the
rec errors and margins (float32 summation order carried through the
lr = 10 momentum steps, as tests/test_torch_project.py states), equal
predictions and accuracies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.configs import Config as JaxConfig
from defensegan_tpu.defense.project import sample_z0 as jax_sample_z0
from defensegan_tpu.eval import accuracy as jax_accuracy
from defensegan_tpu.eval import detect as jax_detect
from defensegan_tpu.gan import DefenseGAN as JaxGAN
from defensegan_tpu.models import build_classifier as jax_classifier
from defensegan_torch.ckpt.bridge import load_flax_tree
from defensegan_torch.configs import Config
from defensegan_torch.eval import accuracy, detect
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.models import build_classifier

torch.set_num_threads(2)


def _scores(seed=0, n=(40, 30), ties=True):
    rng = np.random.RandomState(seed)
    neg = rng.randn(n[0])
    pos = rng.randn(n[1]) + 0.7
    if ties:
        neg[:5] = 0.25
        pos[:3] = 0.25
    return neg, pos


def test_roc_functions_equal_jax():
    neg, pos = _scores()
    assert detect.roc_auc(neg, pos) == jax_detect.roc_auc(neg, pos)
    for a, b in zip(detect.roc_points(neg, pos),
                    jax_detect.roc_points(neg, pos)):
        np.testing.assert_array_equal(a, b)
    for fpr in (0.0, 0.05, 0.3):
        assert detect.tpr_at_fpr(neg, pos, fpr) == \
            jax_detect.tpr_at_fpr(neg, pos, fpr)
    assert detect.bootstrap_auc_ci(neg, pos, n_boot=50, seed=3) == \
        jax_detect.bootstrap_auc_ci(neg, pos, n_boot=50, seed=3)
    with pytest.raises(ValueError):
        detect.roc_auc([], pos)


def test_score_functions_equal_jax():
    rng = np.random.RandomState(1)
    errs, calib = rng.rand(50), rng.rand(30)
    m, mcal = rng.randn(50), rng.randn(30)
    np.testing.assert_array_equal(detect.two_sided_scores(errs, calib),
                                  jax_detect.two_sided_scores(errs, calib))
    np.testing.assert_array_equal(
        detect.combined_scores(errs, m, calib, mcal),
        jax_detect.combined_scores(errs, m, calib, mcal))
    mis = rng.rand(50) > 0.5
    assert detect.undetected_success_rate(calib, errs, mis) == \
        jax_detect.undetected_success_rate(calib, errs, mis)
    with pytest.raises(ValueError):
        detect.undetected_success_rate(calib, errs, mis[:3])


@pytest.mark.parametrize("detector", ["two_sided", "one_sided", "combined"])
def test_calibration_sweep_equals_jax(detector):
    rng = np.random.RandomState(2)
    ec, ea = rng.rand(60), rng.rand(40) + 0.2
    kw = dict(detector=detector, sizes=(8, 16), trials=20, seed=4)
    if detector == "combined":
        kw.update(margins_clean=rng.randn(60), margins_adv=rng.randn(40))
    assert detect.calibration_sweep(ec, ea, **kw) == \
        jax_detect.calibration_sweep(ec, ea, **kw)
    with pytest.raises(ValueError):
        detect.calibration_sweep(ec, ea, detector=detector, sizes=(60,))


# ------------------------------------------------ through a tiny defense
RR, L, LATENT, BS = 2, 4, 16, 8


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("run"))
    kw = dict(type="mnist", gen_arch="wide", gen_dim=4, disc_dim=4,
              latent_dim=LATENT, rec_rr=RR, rec_iters=L,
              compute_dtype="float32", output_dir=out)
    jgan = JaxGAN(JaxConfig(**kw), key=jax.random.key(2))
    tgan = DefenseGAN(Config(**kw), device="cpu")
    load_flax_tree(tgan.generator,
                   jax.tree.map(np.asarray, jgan.state.gen_params),
                   jax.tree.map(np.asarray, jgan.state.gen_stats))
    jm = jax_classifier("E")
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(3), jnp.zeros((1, 28, 28, 1)))["params"])
    tm = load_flax_tree(build_classifier("E"), params).requires_grad_(False)

    def jl(x):
        return jm.apply({"params": params}, x, train=False)
    rng = np.random.RandomState(5)
    x = rng.rand(13, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, 13).astype(np.int32)
    key = jax.random.key(6)

    def key_fn(lo):
        return jax.random.fold_in(key, lo)

    def z0_fn(lo):
        return torch.from_numpy(np.array(jax_sample_z0(key_fn(lo), BS, RR,
                                                       LATENT)))
    return jgan, tgan, jl, tm, x, y, key_fn, z0_fn


def test_reconstruction_errors_and_features_match_jax(pair):
    jgan, tgan, jl, tm, x, _, key_fn, z0_fn = pair
    ref = jax_detect.reconstruction_errors(jgan, x, batch_size=BS,
                                           key_fn=key_fn)
    got = detect.reconstruction_errors(tgan, x, batch_size=BS, z0_fn=z0_fn)
    assert got.shape == (13,) and got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=1e-3)
    rf = jax_detect.detection_features(jgan, x, jl, batch_size=BS,
                                       key_fn=key_fn)
    gf = detect.detection_features(tgan, x, tm, batch_size=BS, z0_fn=z0_fn)
    np.testing.assert_allclose(gf.errs, rf.errs, rtol=1e-3)
    np.testing.assert_allclose(gf.margins, rf.margins, rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(gf.all_losses, rf.all_losses, rtol=1e-3)
    np.testing.assert_array_equal(gf.preds, rf.preds)
    assert gf.all_losses.shape == (13, RR)


def test_model_eval_and_model_eval_gan_match_jax(pair):
    jgan, tgan, jl, tm, x, y, key_fn, z0_fn = pair
    assert accuracy.model_eval(tm, x, y, batch_size=5) == \
        jax_accuracy.model_eval(jl, x, y, batch_size=5)
    ref, rc = jax_accuracy.model_eval_gan(jgan, jl, x, y, batch_size=BS,
                                          key_fn=key_fn,
                                          return_correct=True)
    got, gc = accuracy.model_eval_gan(tgan, tm, x, y, batch_size=BS,
                                      z0_fn=z0_fn, return_correct=True)
    assert got == ref and gc.shape == (13,)
    np.testing.assert_array_equal(gc, rc)
    assert tgan.last_kernel == "packed"
    # without z0_fn the draws come from the generator, in batch order:
    # two generators seeded alike pair the clean and adversarial passes
    a = detect.reconstruction_errors(tgan, x, torch.Generator().manual_seed(
        1), batch_size=BS)
    b = detect.reconstruction_errors(tgan, x, torch.Generator().manual_seed(
        1), batch_size=BS)
    np.testing.assert_array_equal(a, b)
