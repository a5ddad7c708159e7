"""The port's accuracy-level int8 gate (defensegan_torch/cli/
int8_accuracy_gate.py, run by scripts/int8_accuracy_gate_torch.py) against
the JAX script's computation (scripts/int8_accuracy_gate.py:55-69) on the
CPU.

A tiny wide generator (GEN_DIM 4, LATENT_DIM 16, R 2, L 3, float32), a
JAX init bridged to the port, on 48 seeded images. A seeded classifier
has one answer for every image this narrow generator makes, so the rows
are held with a fixed linear classifier on G(z*) (the same numpy weights
on both sides, labels its purified answers on the clean images through
xla), whose purified predictions differ image by image; the bare FGSM
check takes classifier A, a JAX init bridged to the port.
The JAX side reaches its Pallas kernels as on a TPU (its resolver told so)
in interpret mode, tile 256; the port's kernel requests run their CUDA
wrappers, which take their plain versions on CPU tensors (its resolver
told it runs on the card). JAX's restart draws (key 9, split per batch)
are passed to the port. Accuracies are counts over the same images: the
rows must be equal. Tie rule: a purified image whose JAX top-2 logit
margin is under 1e-3 could flip on float32 summation order, and the test
asserts there is none, so equality is the whole claim. The bare FGSM
images: equal where JAX's |d loss / dx| >= 1e-7 (test_torch_attacks.py's
FGSM bound), and the bare accuracies equal.
"""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import defensegan_tpu.gan.defense_gan as jax_dg
import defensegan_tpu.kernels as jax_kernels
import defensegan_torch.gan.defense_gan as torch_dg
from defensegan_tpu.attacks.fgsm import _xent as jax_xent
from defensegan_tpu.attacks.fgsm import fgsm as jax_fgsm
from defensegan_tpu.configs import Config as JaxConfig
from defensegan_tpu.eval.accuracy import model_eval as jax_model_eval
from defensegan_tpu.eval.accuracy import model_eval_gan as jax_model_eval_gan
from defensegan_tpu.gan import DefenseGAN as JaxGAN
from defensegan_tpu.models import build_classifier as jax_classifier
from defensegan_torch.attacks.fgsm import fgsm
from defensegan_torch.ckpt.bridge import load_flax_tree
from defensegan_torch.cli import int8_accuracy_gate as gate
from defensegan_torch.configs import Config, save_config
from defensegan_torch.eval.accuracy import model_eval
from defensegan_torch.eval.classifier import ClassifierState
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.kernels import build
from defensegan_torch.models import build_classifier

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LATENT, RR, ITERS, N, BATCH = 16, 2, 3, 48, 256
# the JAX script prints these two rows (scripts/int8_accuracy_gate.py:53,
# :68)
JAX_BARE_KEYS = {"clean_acc", "fgsm01_acc"}
JAX_KERNEL_KEYS = {"kernel", "clean_defended", "fgsm01_defended"}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _kw(out):
    return dict(type="mnist", gen_arch="wide", gen_dim=4, disc_dim=4,
                latent_dim=LATENT, rec_rr=RR, rec_iters=ITERS,
                compute_dtype="float32", output_dir=out)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The JAX DefenseGAN and the port's, same weights, and classifier A
    each (the port's a trained-looking ClassifierState)."""
    out = str(tmp_path_factory.mktemp("gate"))
    jgan = JaxGAN(JaxConfig(**_kw(out)), key=jax.random.key(2))
    tgan = DefenseGAN(Config(**_kw(out)), device="cpu")
    load_flax_tree(tgan.generator, _np_tree(jgan.state.gen_params),
                   _np_tree(jgan.state.gen_stats))
    jc = jax_classifier("A")
    cparams = _np_tree(jc.init(jax.random.key(5),
                               jnp.zeros((1, 28, 28, 1)))["params"])
    tc = load_flax_tree(build_classifier("A"), cparams)

    def jlogits(x):
        return jc.apply({"params": cparams}, x, train=False)
    return jgan, jlogits, tgan, ClassifierState(tc.requires_grad_(False))


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 28, 28, 1).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32))


def _jax_draws(key, n):
    """JAX's z0 for each batch offset (eval/accuracy.py::
    batched_reconstruct: one split of the key a batch, batch 256)."""
    draws = {}
    for lo in range(0, n, BATCH):
        key, k = jax.random.split(key)
        draws[lo] = torch.from_numpy(np.array(
            jax.random.normal(k, (BATCH, RR, LATENT))))
    return draws


@pytest.fixture
def on_the_accelerators(monkeypatch):
    """Both resolvers take the CPU for their accelerator: JAX's Pallas
    kernels run in interpret mode, the port's kernel wrappers their plain
    versions."""
    jax_resolve = jax_dg.resolve_projection_kernel
    monkeypatch.setattr(jax_dg, "resolve_projection_kernel",
                        lambda gan, **kw: jax_resolve(gan, on_tpu=True,
                                                      **kw))
    for name in ("make_pallas_dense_reconstructor",
                 "make_pallas_dense_int8_reconstructor"):
        monkeypatch.setattr(jax_kernels, name, functools.partial(
            getattr(jax_kernels, name), interpret=True))
    torch_resolve = torch_dg._resolve
    monkeypatch.setattr(torch_dg, "_resolve",
                        lambda gan, **kw: torch_resolve(gan, on_cuda=True,
                                                        **kw))


@pytest.fixture(scope="module")
def linear(pair):
    """logits = 20 (x - c) . W for a fixed image c (G at z = 0) and a
    seeded W, in JAX and in torch."""
    tgan = pair[2]
    with torch.no_grad():
        c = tgan.generator(torch.zeros(1, LATENT)).numpy().reshape(1, -1)
        c = (c + 1.0) / 2.0                      # image space
    w = np.random.RandomState(7).randn(784, 10).astype(np.float32) * 20.0

    def jlogits(x):
        return (jnp.reshape(x, (x.shape[0], -1)) - c) @ w

    def tlogits(x):
        x = torch.as_tensor(x)
        return (x.reshape(x.shape[0], -1) - torch.from_numpy(c)) @ \
            torch.from_numpy(w)
    return jlogits, tlogits


def test_kernel_rows_match_jax(pair, linear, on_the_accelerators):
    jgan, _, tgan, _ = pair
    jlogits, tlogits = linear
    x, _ = _data()
    draws = _jax_draws(jax.random.key(9), N)
    with torch.no_grad():
        y = tlogits(tgan.reconstruct(x, kernel="xla", z0=draws[0][:N])
                    .x_hat).argmax(-1).numpy().astype(np.int32)
    adv = np.asarray(jax_fgsm(jlogits, jnp.asarray(x), jnp.asarray(y),
                              0.1))
    # the JAX script's loop (scripts/int8_accuracy_gate.py:56-68)
    key = jax.random.key(9)
    ref, paths = [], []
    for kernel in gate.KERNELS:
        jgan.cfg.projection_kernel = kernel
        jgan._reconstructors.clear()
        ref.append({"kernel": kernel,
                    "clean_defended": jax_model_eval_gan(
                        jgan, jlogits, x, y, key=key),
                    "fgsm01_defended": jax_model_eval_gan(
                        jgan, jlogits, adv, y, key=key)})
        paths.append(jax_dg.resolve_projection_kernel(jgan, n=BATCH * RR))
    jgan.cfg.projection_kernel = "auto"
    assert paths == ["xla", "pallas", "pallas_int8"]

    before = dict(build.LAUNCHES)
    got = gate.kernel_rows(tgan, tlogits, x, y, adv,
                           z0_fn=draws.__getitem__)
    assert build.LAUNCHES == before          # plain versions on the CPU
    assert [r.pop("path") for r in got] == list(gate.KERNELS)
    assert got == ref
    # the rows are no constant: purified predictions differ image by image
    assert ref[0]["clean_defended"] == 1.0
    assert 0.0 < ref[0]["fgsm01_defended"] < 1.0
    # the tie rule: no purified image within 1e-3 of a flip on JAX's side
    for kernel in gate.KERNELS:
        for xs in (x, adv):
            res = tgan.reconstruct(xs, kernel=kernel, z0=draws[0][:N])
            assert len(set(tlogits(res.x_hat).argmax(-1).tolist())) >= 4
            top2 = np.sort(np.asarray(jlogits(jnp.asarray(
                res.x_hat.numpy()))), axis=-1)[:, -2:]
            assert (top2[:, 1] - top2[:, 0]).min() > 1e-3


def test_bare_fgsm_and_accuracy_match_jax(pair):
    _, jlogits, _, clf = pair
    x, y = _data(seed=1)
    ref = np.asarray(jax_fgsm(jlogits, jnp.asarray(x), jnp.asarray(y),
                              0.1))
    g = np.asarray(jax.grad(lambda xx: jnp.mean(jax_xent(
        jlogits(xx), jnp.asarray(y))))(jnp.asarray(x)))
    got = fgsm(clf.logits_fn(), torch.from_numpy(x), torch.from_numpy(y),
               0.1).numpy()
    keep = np.abs(g) >= 1e-7
    assert keep.mean() > 0.5
    np.testing.assert_allclose(got[keep], ref[keep], atol=1e-6)
    assert model_eval(clf.logits_fn(), got, y) == \
        jax_model_eval(jlogits, ref, y)
    assert model_eval(clf.logits_fn(), x, y) == jax_model_eval(jlogits, x, y)


class _Data:
    def __init__(self):
        self.splits = {"train": _data(64, 2), "test": _data(N, 3)}

    def load(self, split):
        return self.splits[split]


@pytest.fixture
def run(tmp_path, monkeypatch):
    """A tiny run with a weight export, a small stand-in dataset, rows
    under tmp_path."""
    d = str(tmp_path / "run")
    save_config(Config(**_kw(d)))
    gan = DefenseGAN(Config(**_kw(d)), device="cpu")
    gan.step = 3
    gan.write_export()
    monkeypatch.setattr(gate, "get_dataset", lambda name: _Data())
    monkeypatch.setattr(gate, "RESULTS_DIR", str(tmp_path / "results"))
    return d


def test_main_writes_the_jax_rows_plus_device(run, tmp_path):
    rows = gate.main(["--cfg", run, "--device", "cpu"])
    written = [json.loads(line) for line in
               open(tmp_path / "results" / "int8_accuracy_gate.jsonl")]
    assert written == rows and len(rows) == 4
    assert set(rows[0]) == JAX_BARE_KEYS | {"device"}
    for row, kernel in zip(rows[1:], gate.KERNELS):
        assert set(row) == JAX_KERNEL_KEYS | {"device"}
        assert row["kernel"] == kernel and row["device"]["type"] == "cpu"
        assert 0.0 <= row["clean_defended"] <= 1.0
    # on the CPU every request runs the plain path: one path, one result
    assert len({(r["clean_defended"], r["fgsm01_defended"])
                for r in rows[1:]}) == 1
    assert not (ROOT / "output" / "results" /
                "int8_accuracy_gate.jsonl").exists()


def test_exact_numerics_sets_and_restores_the_switches():
    """main() gates in exact_numerics(): deterministic cuDNN, no TF32 in
    products or convolutions; the caller's switches come back after, also
    when the gate raises."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul

    def switches():
        return (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
                matmul.allow_tf32)

    saved = switches()
    try:
        cudnn.deterministic, cudnn.benchmark = False, True
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        with gate.exact_numerics():
            assert switches() == (True, False, False, False)
        assert switches() == (False, True, True, True)
        with pytest.raises(RuntimeError):
            with gate.exact_numerics():
                raise RuntimeError("gate failed")
        assert switches() == (False, True, True, True)
    finally:
        (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
         matmul.allow_tf32) = saved


def test_parser_flags_defaults_and_refusals(run, tmp_path):
    src = (ROOT / "scripts" / "int8_accuracy_gate.py").read_text()
    assert "add_argument" not in src            # the JAX script has none
    ap = gate.build_parser()
    assert {s for a in ap._actions for s in a.option_strings
            if s.startswith("--")} == {"--help", "--cfg", "--device"}
    a = ap.parse_args([])
    assert (a.cfg, a.device) == (gate.FLAGSHIP_CFG, "cuda")
    assert a.cfg.endswith("configs/gans/mnist_fast.yml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gate.main(["--cfg", run])
    empty = str(tmp_path / "empty")
    save_config(Config(**_kw(empty)))
    with pytest.raises(SystemExit, match="no trained GAN"):
        gate.main(["--cfg", empty, "--device", "cpu"])
