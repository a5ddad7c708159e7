"""PyTorch port vs JAX: the serving entry points on 64x64x3 inputs
(eval/accuracy.py::batched_reconstruct, defense/pipeline.py::
DefendedPipeline, defense/audit.py::AuditedPipeline), float and uint8, a
two-class classifier, PROJECTION_KERNEL pallas_v4.

A narrow 3-deconv CelebA generator (GEN_DIM 4, LATENT_DIM 16), the same
weights (JAX inits, bridged) and the same z0 draws in both packages. On the
CPU `pallas_v4` resolves to the plain generic path in both, so this holds
the port's serving code, not the kernel, against the JAX package's: float32,
tolerances as tests/test_torch_pipeline.py (1e-3 relative on losses carried
through the momentum-GD loop, 1e-3 absolute on logit margins). The same
entry points with the v4 loop itself under them (its plain version, as a CPU
tensor runs it) are held against the generic path at the loop's bf16
tolerance.
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
from defensegan_torch.defense.audit import AuditedPipeline
from defensegan_torch.defense.pipeline import DefendedPipeline
from defensegan_torch.eval.accuracy import batched_reconstruct
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.models import build_classifier

torch.set_num_threads(2)

LATENT, RR, ITERS, BATCH = 16, 2, 3, 4
SHAPE = (64, 64, 3)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("run"))
    kw = dict(type="celeba", gen_arch="wide", gen_dim=4, disc_dim=4,
              latent_dim=LATENT, image_size=64, channels=3, num_classes=2,
              rec_rr=RR, rec_iters=ITERS, compute_dtype="float32",
              projection_kernel="pallas_v4", output_dir=out)
    jgan = JaxGAN(JaxConfig(**kw))
    tgan = DefenseGAN(Config(**kw), device="cpu")
    load_flax_tree(tgan.generator, _np_tree(jgan.state.gen_params),
                   _np_tree(jgan.state.gen_stats))
    jc = jax_clf("E", num_classes=2)
    cparams = _np_tree(jc.init(jax.random.key(3),
                               jnp.zeros((1,) + SHAPE))["params"])
    tc = build_classifier("E", num_classes=2, image_shape=SHAPE)
    load_flax_tree(tc, cparams)
    return (jgan, lambda x: jc.apply({"params": cparams}, x),
            tgan, tc.requires_grad_(False))


def _jax_draws(key, n, rr=RR):
    """z0 of each batch as the JAX pipeline draws it for one pass."""
    draws = {}
    for lo in range(0, n, BATCH):
        key, k = jax.random.split(key)
        draws[lo] = torch.from_numpy(np.array(
            jax.random.normal(k, (BATCH, rr, LATENT))))
    return draws


def _images(seed, n, dtype):
    x = np.random.RandomState(seed).rand(n, *SHAPE).astype(np.float32)
    return np.round(x * 255).astype(np.uint8) if dtype == "uint8" else x


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_batched_reconstruct_on_64x64(pair, dtype):
    _, _, tgan, _ = pair
    x = _images(4, 6, dtype)
    draws = _jax_draws(jax.random.key(0), 6)
    seen = []
    for res, lo, hi in batched_reconstruct(tgan, x, batch_size=BATCH,
                                           z0_fn=draws.__getitem__):
        seen.append((lo, hi))
        assert tgan.last_kernel == "xla"          # pallas_v4 off the card
        assert res.x_hat.shape == (BATCH,) + SHAPE
        assert res.x_hat.dtype == torch.float32
        assert res.all_losses.shape == (BATCH, RR)
        assert torch.isfinite(res.all_losses).all()
        # the same rows as float images in [0, 1], padded by hand
        xf = torch.from_numpy(x[lo:hi]).float()
        if dtype == "uint8":
            xf = xf / 255.0
        direct = tgan.reconstruct(
            torch.cat([xf, torch.zeros((BATCH - (hi - lo),) + SHAPE)]),
            z0=draws[lo])
        torch.testing.assert_close(res.all_losses, direct.all_losses,
                                   rtol=1e-5, atol=1e-7)
    assert seen == [(0, 4), (4, 6)]


@pytest.mark.parametrize("dtype,detector", [("float32", "two_sided"),
                                            ("uint8", "two_sided"),
                                            ("float32", "combined3")])
def test_pipeline_on_64x64_matches_jax(pair, dtype, detector):
    jgan, jlogits, tgan, tclf = pair
    x_cal = _images(5, 8, dtype)
    x = np.concatenate([x_cal[:3], _images(6, 3, dtype)])
    kc, kp = jax.random.key(10), jax.random.key(11)
    jp = JaxPipeline(jgan, jlogits, detector=detector)
    jp.calibrate(x_cal, kc, batch_size=BATCH)
    ref = jp.predict(x, kp, batch_size=BATCH)

    cal, req = _jax_draws(kc, 8), _jax_draws(kp, 6)
    tp = DefendedPipeline(tgan, tclf, detector=detector)
    tp.calibrate(x_cal, batch_size=BATCH, z0_fn=lambda p, lo: cal[lo])
    got = tp.predict(x, batch_size=BATCH, z0_fn=lambda p, lo: req[lo])
    assert set(np.unique(got.pred)) <= {0, 1}
    np.testing.assert_array_equal(got.pred, ref.pred)
    np.testing.assert_allclose(got.rec_err, ref.rec_err, rtol=1e-3)
    np.testing.assert_allclose(got.margin, ref.margin, atol=1e-3)
    np.testing.assert_array_equal(got.flagged, ref.flagged)


def test_audited_pipeline_on_64x64_matches_jax(pair):
    jgan, jlogits, tgan, tclf = pair
    serve, audit = dict(rec_rr=2, rec_iters=2), dict(rec_rr=3, rec_iters=4)
    jp = JaxAudited(JaxPipeline(jgan, jlogits, **serve),
                    JaxPipeline(jgan, jlogits, **audit), audit_prob=0.5)
    tp = AuditedPipeline(DefendedPipeline(tgan, tclf, **serve),
                         DefendedPipeline(tgan, tclf, **audit),
                         audit_prob=0.5)
    x_cal = _images(7, 8, "float32")
    x = np.concatenate([x_cal[:2], _images(8, 6, "float32")])
    kc, kp = jax.random.key(20), jax.random.key(21)
    jp.calibrate(x_cal, kc, batch_size=BATCH)
    ref = jp.predict(x, kp, batch_size=BATCH)
    assert ref.audited.any()
    ks, ka = jax.random.split(kc)
    scal, acal = _jax_draws(ks, 8, 2), _jax_draws(ka, 8, 3)
    tp.calibrate(x_cal, batch_size=BATCH,
                 serve_z0_fn=lambda p, lo: scal[lo],
                 audit_z0_fn=lambda p, lo: acal[lo])
    _, k_audit = jax.random.split(jax.random.fold_in(kp, 0xA0D17))
    sreq = _jax_draws(kp, 8, 2)
    areq = _jax_draws(k_audit, int(ref.audited.sum()), 3)
    got = tp.predict(x, batch_size=BATCH, audited=ref.audited,
                     serve_z0_fn=lambda p, lo: sreq[lo],
                     audit_z0_fn=lambda p, lo: areq[lo])
    np.testing.assert_array_equal(got.pred, ref.pred)
    np.testing.assert_array_equal(got.flagged, ref.flagged)
    np.testing.assert_allclose(got.serve.rec_err, ref.serve.rec_err,
                               rtol=1e-3)
    np.testing.assert_allclose(got.audit.rec_err, ref.audit.rec_err,
                               rtol=1e-3)


def test_pipeline_over_the_v4_loop_agrees_with_the_generic_path(pair):
    """The serving entry points with the fused v4 loop under them, as the
    card runs them: the resolver is told it is on CUDA, the tensors stay on
    the CPU, so the wrapper runs the loop's plain version. Against the
    float32 generic path the bf16 loop's losses agree to 5% (bf16 operands
    through three steps and the bf16-free float32 epilogue) and pick the
    same classes."""
    _, _, tgan, tclf = pair
    x = _images(9, 4, "uint8")
    z0 = torch.from_numpy(np.random.RandomState(9).randn(4, RR, LATENT)
                          .astype(np.float32))
    ref = tgan.reconstruct(x, kernel="xla", z0=z0)
    fn = tgan._reconstructor_for("v4", RR, ITERS, tgan.cfg.rec_lr)
    got = fn(torch.as_tensor(x), z0=z0)
    assert got.x_hat.shape == (4,) + SHAPE
    np.testing.assert_allclose(got.all_losses.numpy(),
                               ref.all_losses.numpy(), rtol=5e-2)
    with torch.no_grad():
        assert torch.equal(tclf(got.x_hat).argmax(-1),
                           tclf(ref.x_hat).argmax(-1))
