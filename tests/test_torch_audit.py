"""PyTorch port vs JAX: AuditedPipeline (defensegan_torch/defense/audit.py).

Same weights (JAX inits, bridged), the same z0 draws (the JAX pipelines
draw each batch's z0 from splits of their keys; the port replays exactly
those through z0_fn) and the same audit-selection mask (the two frameworks
draw different streams, so the JAX mask is injected through `audited`).
The cascade must then compose the same way: serve and audit results,
`pred` (the audit's where audited), `flagged` (serve OR audit) and
`audited`. float32; tolerances as tests/test_torch_pipeline.py (1e-3
relative on losses carried through the momentum-GD loop).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.configs import Config as JaxConfig
from defensegan_tpu.defense.audit import AuditedPipeline as JaxAudited
from defensegan_tpu.defense.pipeline import DefendedPipeline as JaxPipeline
from defensegan_tpu.gan import DefenseGAN as JaxGAN
from defensegan_tpu.models.classifiers import build_classifier as jax_clf
from defensegan_torch.ckpt.bridge import load_flax_tree
from defensegan_torch.configs import Config
from defensegan_torch.defense.audit import AuditedPipeline, AuditResult
from defensegan_torch.defense.pipeline import DefendedPipeline
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.models import build_classifier

torch.set_num_threads(2)

LATENT, BATCH = 16, 4
SERVE = dict(rec_rr=2, rec_iters=2)
AUDIT = dict(rec_rr=3, rec_iters=4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("run"))
    kw = dict(type="mnist", gen_arch="wide", gen_dim=4, disc_dim=4,
              latent_dim=LATENT, compute_dtype="float32", output_dir=out)
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


def _jax_draws(key, n, rr):
    """z0 of each batch as the JAX pipeline draws it for one pass
    (eval/accuracy.py::batched_reconstruct key splits), as a z0_fn."""
    draws = {}
    for lo in range(0, n, BATCH):
        key, k = jax.random.split(key)
        draws[lo] = torch.from_numpy(np.array(
            jax.random.normal(k, (BATCH, rr, LATENT))))
    return lambda p, lo: draws[lo]


def _pipes(pair, audit_prob, detector="two_sided"):
    jgan, jlogits, tgan, tclf = pair
    jp = JaxAudited(JaxPipeline(jgan, jlogits, detector=detector, **SERVE),
                    JaxPipeline(jgan, jlogits, detector=detector, **AUDIT),
                    audit_prob=audit_prob)
    tp = AuditedPipeline(
        DefendedPipeline(tgan, tclf, detector=detector, **SERVE),
        DefendedPipeline(tgan, tclf, detector=detector, **AUDIT),
        audit_prob=audit_prob)
    return jp, tp


def _close(got, ref):
    np.testing.assert_array_equal(got.pred, ref.pred)
    np.testing.assert_array_equal(got.flagged, ref.flagged)
    np.testing.assert_allclose(got.rec_err, ref.rec_err, rtol=1e-3)
    np.testing.assert_allclose(got.margin, ref.margin, atol=1e-3)


@pytest.mark.parametrize("audit_prob,detector", [(0.5, "two_sided"),
                                                 (0.3, "combined"),
                                                 (1.0, "one_sided")])
def test_audited_pipeline_matches_jax(pair, audit_prob, detector):
    jp, tp = _pipes(pair, audit_prob, detector)
    rng = np.random.RandomState(7)
    x_cal = rng.rand(8, 28, 28, 1).astype(np.float32)
    x = np.concatenate([x_cal[:3], rng.rand(7, 28, 28, 1)]).astype(
        np.float32)
    kc, kp = jax.random.key(20), jax.random.key(21)
    jp.calibrate(x_cal, kc, batch_size=BATCH)
    ref = jp.predict(x, kp, batch_size=BATCH)
    assert ref.audited.any()

    ks, ka = jax.random.split(kc)
    tp.calibrate(x_cal, batch_size=BATCH,
                 serve_z0_fn=_jax_draws(ks, 8, SERVE["rec_rr"]),
                 audit_z0_fn=_jax_draws(ka, 8, AUDIT["rec_rr"]))
    assert tp.calibrated
    _, k_audit = jax.random.split(jax.random.fold_in(kp, 0xA0D17))
    n_sub = int(ref.audited.sum())
    got = tp.predict(
        x, batch_size=BATCH, audited=ref.audited,
        serve_z0_fn=_jax_draws(kp, 10, SERVE["rec_rr"]),
        audit_z0_fn=_jax_draws(k_audit, n_sub, AUDIT["rec_rr"]))
    assert isinstance(got, AuditResult)
    np.testing.assert_array_equal(got.audited, ref.audited)
    _close(got.serve, ref.serve)
    _close(got.audit, ref.audit)
    np.testing.assert_array_equal(got.pred, ref.pred)
    np.testing.assert_array_equal(got.flagged, ref.flagged)
    # the composition rule itself
    a = got.audited
    np.testing.assert_array_equal(got.pred[a], got.audit.pred)
    np.testing.assert_array_equal(got.pred[~a], got.serve.pred[~a])
    np.testing.assert_array_equal(
        got.flagged[a], got.serve.flagged[a] | got.audit.flagged)
    np.testing.assert_array_equal(got.flagged[~a], got.serve.flagged[~a])
    assert got.pred.dtype == np.int32 and got.audited.dtype == bool


def test_empty_audit_mask_runs_the_serve_pass_only(pair):
    _, tp = _pipes(pair, 0.5)
    x = np.random.RandomState(8).rand(6, 28, 28, 1).astype(np.float32)
    tp.calibrate(x, batch_size=BATCH)
    got = tp.predict(x, batch_size=BATCH, audited=np.zeros(6, bool))
    assert got.audit is None and not got.audited.any()
    np.testing.assert_array_equal(got.pred, got.serve.pred)
    np.testing.assert_array_equal(got.flagged, got.serve.flagged)
    with pytest.raises(ValueError, match="audited mask"):
        tp.predict(x, batch_size=BATCH, audited=np.zeros(5, bool))


def test_seeded_selection_reproduces(pair):
    """Selection is a function of the pipeline's seed and call order: two
    pipelines with one seed select the same rows call after call (and so
    predict the same), another seed selects others, and the rate tracks
    audit_prob."""
    jgan, jlogits, tgan, tclf = pair
    serve = DefendedPipeline(tgan, tclf, **SERVE)
    audit = DefendedPipeline(tgan, tclf, **AUDIT)
    a = AuditedPipeline(serve, audit, 0.3, seed=5)
    b = AuditedPipeline(serve, audit, 0.3, seed=5)
    c = AuditedPipeline(serve, audit, 0.3, seed=6)
    for _ in range(2):
        ma, mb, mc = a.select(200), b.select(200), c.select(200)
        np.testing.assert_array_equal(ma, mb)
        assert (ma != mc).any()
        assert 0.15 < ma.mean() < 0.45
    x = np.random.RandomState(9).rand(8, 28, 28, 1).astype(np.float32)
    a.calibrate(x, batch_size=BATCH)          # shared pipelines: b, c too
    ra = a.predict(torch.from_numpy(x), batch_size=BATCH)
    rb = b.predict(torch.from_numpy(x), batch_size=BATCH)
    np.testing.assert_array_equal(ra.audited, rb.audited)
    np.testing.assert_array_equal(ra.pred, rb.pred)
    np.testing.assert_array_equal(ra.flagged, rb.flagged)


@pytest.mark.parametrize("audit_prob", [0.0, -0.1, 1.5])
def test_audit_prob_out_of_range_raises(pair, audit_prob):
    jgan, jlogits, tgan, tclf = pair
    serve = DefendedPipeline(tgan, tclf, **SERVE)
    with pytest.raises(ValueError, match="audit_prob"):
        AuditedPipeline(serve, serve, audit_prob)
    with pytest.raises(ValueError, match="audit_prob"):
        JaxAudited(None, None, audit_prob)


def test_predict_before_calibrate_raises(pair):
    _, tp = _pipes(pair, 0.5)
    assert not tp.calibrated
    with pytest.raises(RuntimeError, match="calibrate"):
        tp.predict(np.zeros((1, 28, 28, 1), np.float32))
