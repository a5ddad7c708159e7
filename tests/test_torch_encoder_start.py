"""The encoder start under a given table (defensegan_torch/gan/
defense_gan.py::DefenseGAN.reconstruct) on the CPU, against the JAX
package and the benchmark's plain float32 reference.

Under init "encoder" or "encoder_jitter" a caller's table z0 [B, R, k] is
projected as given, except that a row whose restart 0 holds a NaN starts
that restart at the model's own E(x). JAX's reconstruct takes no table:
its encoder start is E(x) in restart 0 and the key's draws behind it, so
the port is handed a table of NaN in restart 0 and those draws behind
it. Tiny wide MNIST generator (mnist_fast's topology, GEN_DIM 4, LATENT
16) and encoder (DISC_DIM 4: channels 4, 8), seeded by JAX's inits and
bridged; float32 throughout, `xla` path.

Tolerances: the port against itself is bit for bit (the same float
operations on the same starts). Against JAX and the plain reference the
two sides sum in float32 in different orders (~1e-7 relative), which the
momentum-GD loop carries: losses 1e-3 relative, as
tests/test_torch_pipeline.py; E(x) 1e-5 absolute, as
benchmark/tests/test_benchmark_encoder.py; gradients as
tests/test_torch_backprop.py (atol 1e-4 + 1e-3 of the largest element).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.reference.classifier import logits as ref_logits
from benchmark.reference.classifier import weight_shapes as clf_shapes
from benchmark.reference.encoder import EncoderShape, encode as ref_encode
from benchmark.reference.generator import GeneratorShape
from benchmark.reference.generator import generate as ref_generate
from benchmark.reference.projection import project as ref_project
from defensegan_tpu.configs import Config as JaxConfig
from defensegan_tpu.defense.project import reconstruct as jax_reconstruct
from defensegan_tpu.gan import DefenseGAN as JaxGAN
from defensegan_tpu.models.encoder import encoder_for as jax_encoder_for
from defensegan_torch.ckpt.bridge import load_flax_tree
from defensegan_torch.configs import Config
from defensegan_torch.defense.pipeline import DefendedPipeline
from defensegan_torch.defense.project import ReconstructionResult
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.models import build_classifier

torch.set_num_threads(2)

LATENT, RR, B, ITERS = 16, 3, 4, 6
KW = dict(type="mnist", gen_arch="wide", gen_dim=4, disc_dim=4,
          latent_dim=LATENT, rec_rr=RR, compute_dtype="float32",
          projection_kernel="xla")
FIELDS = ReconstructionResult._fields


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v, np.float32))
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """JAX's and the port's DefenseGAN on the same generator and encoder
    weights; the encoder's biases drawn (flax seeds them at zero)."""
    kw = dict(KW, output_dir=str(tmp_path_factory.mktemp("run")))
    jgan = JaxGAN(JaxConfig(**kw), key=jax.random.key(3))
    rng = np.random.RandomState(5)
    stats = jax.tree.map(lambda a: np.asarray(a) + 0.3 * rng.rand(
        *a.shape).astype(np.float32), jgan.state.gen_stats)
    jgan.state = jgan.state.replace(gen_stats=stats)
    enc = jax.tree.map(np.asarray, jax_encoder_for("mnist", 4, z_dim=LATENT)
                       .init(jax.random.key(4), jnp.zeros((1, 28, 28, 1)))
                       ["params"])
    for layer in enc.values():
        layer["bias"] = (0.1 * rng.randn(*layer["bias"].shape)
                         ).astype(np.float32)
    jgan.enc_params = enc
    tgan = DefenseGAN(Config(**kw), device="cpu")
    load_flax_tree(tgan.generator,
                   jax.tree.map(np.asarray, jgan.state.gen_params), stats)
    load_flax_tree(tgan._build_encoder(), enc)
    tgan.weights_changed()
    return jgan, tgan


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, 28, 28, 1).astype(np.float32)
    z0 = rng.randn(B, RR, LATENT).astype(np.float32)
    return x, z0


def _equal(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("rows", ["all", "some"])
@pytest.mark.parametrize("init", ["encoder", "encoder_jitter"])
def test_nan_restart_starts_at_the_models_encoding(pair, init, rows):
    """A NaN restart 0 projects as the table with E(x) (gan.encode) written
    there, bit for bit; rows with a finite restart 0, and every later
    restart, keep the table's values."""
    _, tgan = pair
    x, z0 = _inputs(0)
    nan = np.arange(B) % 2 == 0 if rows == "some" else np.ones(B, bool)
    table = torch.from_numpy(z0.copy())
    table[torch.from_numpy(nan), 0] = float("nan")
    xt = torch.from_numpy(x)
    got = tgan.reconstruct(xt, rec_iters=ITERS, init=init, z0=table)
    want_table = torch.from_numpy(z0.copy())
    want_table[torch.from_numpy(nan), 0] = tgan.encode(xt)[
        torch.from_numpy(nan)]
    want = tgan.reconstruct(xt, rec_iters=ITERS, init=init, z0=want_table)
    assert tgan.last_kernel == "xla"
    assert torch.isfinite(got.all_losses).all()
    _equal(got, want)
    # the caller's table is not written to
    assert torch.isnan(table[torch.from_numpy(nan), 0]).all()


def test_finite_table_under_encoder_init_is_projected_as_given(pair):
    """A finite table under encoder init: the same as under random init,
    bit for bit, and as JAX's projection of that table."""
    jgan, tgan = pair
    x, z0 = _inputs(1)
    xt, zt = torch.from_numpy(x), torch.from_numpy(z0)
    got = tgan.reconstruct(xt, rec_iters=ITERS, init="encoder", z0=zt)
    _equal(got, tgan.reconstruct(xt, rec_iters=ITERS, init="random", z0=zt))
    ref = jax_reconstruct(jgan.gen_apply_tanh, jnp.asarray(x),
                          jnp.asarray(z0), rec_iters=ITERS)
    np.testing.assert_allclose(got.all_losses.numpy(),
                               np.asarray(ref.all_losses), rtol=1e-3)
    np.testing.assert_allclose(got.x_hat.numpy(),
                               np.asarray(ref.x_hat).reshape(x.shape),
                               atol=1e-3)


def test_random_init_projects_the_table_whole(pair):
    """init "random" takes the table as given, NaN included, and runs no
    encoder: the NaN restart's loss is NaN, the others match JAX's
    projection of the finite restarts; no projection.encode span."""
    jgan, tgan = pair
    x, z0 = _inputs(2)
    table = torch.from_numpy(z0.copy())
    table[:, 0] = float("nan")
    with torch.profiler.profile() as prof:
        got = tgan.reconstruct(torch.from_numpy(x), rec_iters=ITERS,
                               init="random", z0=table)
    names = {e.name for e in prof.events()}
    assert "gan.reconstruct" in names and "projection.encode" not in names
    assert torch.isnan(got.all_losses[:, 0]).all()
    ref = jax_reconstruct(jgan.gen_apply_tanh, jnp.asarray(x),
                          jnp.asarray(z0[:, 1:]), rec_iters=ITERS)
    np.testing.assert_allclose(got.all_losses[:, 1:].numpy(),
                               np.asarray(ref.all_losses), rtol=1e-3)


@pytest.mark.parametrize("table", [False, True])
def test_encoder_start_is_a_span_inside_reconstruct(pair, table):
    """projection.encode opens inside gan.reconstruct and closes before
    projection.loop, with a table (NaN start) and without one."""
    _, tgan = pair
    x, z0 = _inputs(3)
    z = torch.from_numpy(z0)
    z[:, 0] = float("nan")
    with torch.profiler.profile() as prof:
        tgan.reconstruct(torch.from_numpy(x), rec_iters=2, init="encoder",
                         z0=z if table else None)
    spans = {e.name: e for e in prof.events() if e.name in (
        "gan.reconstruct", "projection.encode", "projection.loop")}
    assert len(spans) == 3, sorted(spans)
    outer, enc, loop = (spans[n].time_range for n in (
        "gan.reconstruct", "projection.encode", "projection.loop"))
    assert outer.start <= enc.start and enc.end <= loop.start
    assert loop.end <= outer.end


def _grad(run, x, w_img, w_loss):
    xt = torch.from_numpy(x).requires_grad_(True)
    res = run(xt)
    obj = torch.sum(res.x_hat.reshape(w_img.shape) * torch.from_numpy(
        w_img)) + torch.sum(res.loss * torch.from_numpy(w_loss))
    (g,) = torch.autograd.grad(obj, xt)
    return g.numpy()


def _close(got, ref):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 + 1e-3 * scale)


def _jax_grad(jgan, x, rr, iters, init, w_img, w_loss, key):
    def f(xx):
        res = jgan.reconstruct(xx, key, rec_rr=rr, rec_iters=iters,
                               back_prop=True, kernel="xla", init=init)
        return jnp.sum(res.x_hat.reshape(w_img.shape) * w_img) + \
            jnp.sum(res.loss * w_loss)
    return jax.grad(f)(jnp.asarray(x))


def _weights(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 28, 28, 1).astype(np.float32),
            rng.randn(B).astype(np.float32) * 10.0)


@pytest.mark.parametrize("iters", [1, 3])
def test_table_start_gradient_matches_jax(pair, iters):
    """back_prop through a NaN-start table: d/dx reaches x through E(x)
    as JAX's reconstruct(back_prop=True, init="encoder") does (its draws
    handed to the port behind the NaN), and differs from the gradient of
    the same start detached."""
    jgan, tgan = pair
    x, _ = _inputs(10 + iters)
    w_img, w_loss = _weights(20 + iters)
    key = jax.random.key(7)
    draws = np.asarray(jgan._encoder_z0(jnp.asarray(x), key, RR,
                                        "encoder"))[:, 1:]
    table = np.concatenate([np.full((B, 1, LATENT), np.nan, np.float32),
                            draws], axis=1)
    ref = _jax_grad(jgan, x, RR, iters, "encoder", w_img, w_loss, key)
    got = _grad(lambda xt: tgan.reconstruct(
        xt, rec_iters=iters, back_prop=True, kernel="xla", init="encoder",
        z0=torch.from_numpy(table)), x, w_img, w_loss)
    _close(got, ref)
    detached = table.copy()
    detached[:, 0] = tgan.encode(torch.from_numpy(x)).numpy()
    cut = _grad(lambda xt: tgan.reconstruct(
        xt, rec_iters=iters, back_prop=True, kernel="xla", init="encoder",
        z0=torch.from_numpy(detached)), x, w_img, w_loss)
    assert np.abs(cut - np.asarray(ref)).max() > \
        10 * (1e-4 + 1e-3 * np.abs(np.asarray(ref)).max())


@pytest.mark.parametrize("init", ["encoder", "encoder_jitter"])
def test_drawn_start_gradient_matches_jax(pair, init):
    """back_prop with no table at R 1 (no draws, so both packages start at
    E(x) alone): the gradient through E matches JAX's."""
    jgan, tgan = pair
    x, _ = _inputs(30)
    w_img, w_loss = _weights(31)
    ref = _jax_grad(jgan, x, 1, 3, init, w_img, w_loss, jax.random.key(8))
    got = _grad(lambda xt: tgan.reconstruct(
        xt, rec_rr=1, rec_iters=3, back_prop=True, kernel="xla", init=init),
        x, w_img, w_loss)
    _close(got, ref)


def test_no_gradient_through_the_start_without_back_prop(pair):
    _, tgan = pair
    x, z0 = _inputs(4)
    z = torch.from_numpy(z0)
    z[:, 0] = float("nan")
    xt = torch.from_numpy(x).requires_grad_(True)
    res = tgan.reconstruct(xt, rec_iters=2, init="encoder", z0=z)
    assert not res.x_hat.requires_grad and not res.z_star.requires_grad


def test_pipeline_with_a_nan_start_matches_the_plain_reference(pair):
    """DefendedPipeline.predict under rec_init "encoder", its draws handed
    in with NaN in restart 0 (as the benchmark hands them), against the
    benchmark's plain float32 reference: E(x) by reference/encoder.py, the
    projection by reference/projection.py, classifier A by
    reference/classifier.py. rec_err 1e-3 relative (the loop's summation
    order); margins 1e-3 absolute (x_hat's float32 gap through a small
    net); predictions and the detector's center exactly or to 1e-3."""
    jgan, tgan = pair
    n_cal, n = 16, 8
    rng = np.random.RandomState(40)
    x_cal = rng.rand(n_cal, 28, 28, 1).astype(np.float32)
    x = rng.rand(n, 28, 28, 1).astype(np.float32)
    gen = torch.Generator().manual_seed(41)

    def table(m):
        t = torch.randn(m, 2, LATENT, generator=gen)
        t[:, 0] = float("nan")
        return t
    t_cal, t = table(n_cal), table(n)
    clf_w = {k: 0.1 * torch.randn(s, generator=gen)
             for k, s in clf_shapes(10, 28, 1).items()}
    clf = build_classifier("A", 10, image_shape=(28, 28, 1))
    params = {}
    for path, v in clf_w.items():
        layer, leaf = path.split("/")
        params.setdefault(layer, {})[leaf] = v.numpy()
    load_flax_tree(clf, params)
    pipe = DefendedPipeline(tgan, clf, rec_rr=2, rec_iters=ITERS,
                            rec_init="encoder")
    pipe.calibrate(x_cal, z0_fn=lambda p, lo: t_cal[lo:])
    got = pipe.predict(x, z0_fn=lambda p, lo: t[lo:])

    gw = _flat(jax.tree.map(np.asarray, jgan.state.gen_params))
    gw.update(_flat(jax.tree.map(np.asarray, jgan.state.gen_stats)))
    ew = _flat(jgan.enc_params)
    g = tgan.generator
    gshape = GeneratorShape(LATENT, g.base_hw, tuple(g.channels),
                            g.out_channels)
    eshape = EncoderShape((4, 8), LATENT, 1, 28)
    cfg = tgan.cfg

    def ref(xs, tab):
        xs = torch.from_numpy(xs)
        z = tab.clone()
        z[:, 0] = ref_encode(ew, eshape, 2.0 * xs - 1.0)
        return ref_project(lambda zz: ref_generate(gw, gshape, zz), xs, z,
                           iters=ITERS, lr=cfg.rec_lr,
                           momentum=cfg.rec_momentum)
    with torch.no_grad():
        enc_got = tgan.encode(torch.from_numpy(x))
        enc_ref = ref_encode(ew, eshape, 2.0 * torch.from_numpy(x) - 1.0)
    torch.testing.assert_close(enc_got, enc_ref, rtol=1e-5, atol=1e-5)
    cal, res = ref(x_cal, t_cal), ref(x, t)
    np.testing.assert_allclose(got.rec_err,
                               res.losses.min(1).values.numpy(), rtol=1e-3)
    logits = ref_logits(clf_w, res.x_hat)
    top2 = torch.topk(logits, 2, dim=-1).values
    np.testing.assert_allclose(got.margin, (top2[:, 0] - top2[:, 1]).numpy(),
                               atol=1e-3)
    np.testing.assert_array_equal(got.pred,
                                  logits.argmax(-1).numpy().astype(np.int32))
    center = float(np.median(cal.losses.min(1).values.numpy()))
    assert pipe._center == pytest.approx(center, rel=1e-3)
