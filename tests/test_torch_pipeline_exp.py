"""The port's DefendedPipeline operator rows (defensegan_torch/cli/
pipeline_exp.py, run by scripts/pipeline_exp_torch.py) against the JAX
script (scripts/pipeline_exp.py) on the CPU.

The JAX script's own main() runs, with its GAN, data and cached
classifier handed in (its loaders patched), on a tiny wide generator
(GEN_DIM 4, LATENT_DIM 16, R 2, L 3, float32), a JAX init bridged to the
port, a small stand-in dataset (train 32, dev 16, test 24 images, the
attack-eval slice 8, calib_n 12) and two small adversarial sets. The
classifier is a fixed linear map on the image (the same numpy weights on
both sides), whose predictions and margins differ image by image. The
port's main() runs on the same objects with JAX's restart draws (keys 101
and 202, split per batch, pass p > 0 folded in) passed through
`PipelineDraws`. For each calibration source both take the same slice of
the same split; every row has the JAX row's keys plus `device`; flag
rate, acc_all, acc_unflagged and the undetected-success rate are equal
(counts over the same images), the rec-err and margin means within 1e-3
relative (float32 summation order through the projection).
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import defensegan_tpu.cli.common as jax_common
import defensegan_tpu.defense as jax_defense
import defensegan_tpu.eval.classifier as jax_classifier_mod
from defensegan_tpu.configs import Config as JaxConfig
from defensegan_tpu.configs import save_config as jax_save_config
from defensegan_tpu.gan import DefenseGAN as JaxGAN
from defensegan_torch.ckpt.bridge import load_flax_tree
from defensegan_torch.cli import pipeline_exp
from defensegan_torch.configs import Config, save_config
from defensegan_torch.eval import classifier as clf_cache
from defensegan_torch.eval.classifier import ClassifierState
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.models import build_classifier
from test_torch_serving_tools import _jax_flags

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LATENT, RR, ITERS, BATCH = 16, 2, 3, 256
EVAL_N, CALIB_N = 8, 12


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kw(out):
    return dict(type="mnist", gen_arch="wide", gen_dim=4, disc_dim=4,
                latent_dim=LATENT, rec_rr=RR, rec_iters=ITERS,
                compute_dtype="float32", output_dir=out)


def _images(n, seed):
    return np.random.RandomState(seed).rand(n, 28, 28, 1).astype(np.float32)


class _Data:
    splits = {"train": 32, "dev": 16, "test": 24}

    def load(self, split):
        n = self.splits[split]
        return _images(n, n), np.arange(n, dtype=np.int32) % 10


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A run dir (its cfg.yml), the JAX and the port's DefenseGAN on the
    same weights, the linear classifier each side, and two adversarial
    sets."""
    base = tmp_path_factory.mktemp("pipe")
    run = str(base / "run")
    jax_save_config(JaxConfig(**_kw(run)))
    jgan = JaxGAN(JaxConfig(**_kw(run)), key=jax.random.key(3))
    tgan = DefenseGAN(Config(**_kw(run)), device="cpu")
    load_flax_tree(tgan.generator,
                   jax.tree.map(np.asarray, jgan.state.gen_params),
                   jax.tree.map(np.asarray, jgan.state.gen_stats))
    w = np.random.RandomState(7).randn(784, 10).astype(np.float32) * 20.0

    def jlogits(x):
        return (jnp.reshape(x, (x.shape[0], -1)) - 0.5) @ w

    def tlogits(x):
        x = torch.as_tensor(x)
        return (x.reshape(x.shape[0], -1) - 0.5) @ torch.from_numpy(w)
    sets = []
    for i, noise in enumerate((0.05, 0.3)):
        x = _images(10, 100 + i)
        rng = np.random.RandomState(200 + i)
        x_adv = np.clip(x + noise * np.sign(rng.randn(*x.shape)), 0, 1
                        ).astype(np.float32)
        y = tlogits(x).argmax(-1).numpy().astype(np.int32)
        path = base / f"set{i}.npz"
        np.savez(path, x_clean=x, x_adv=x_adv, y=y,
                 meta=json.dumps({"attack": "noise", "eps": noise}))
        sets.append(str(path))
    return run, jgan, jlogits, tgan, tlogits, sets


class _State:
    def __init__(self, fn):
        self.fn = fn

    def logits_fn(self):
        return self.fn


def _jax_draws(key, n, passes):
    """JAX's z0 for (pass, batch offset): DefendedPipeline folds p > 0
    into the key, batched_reconstruct splits it once a batch of 256."""
    out = {}
    for p in range(passes):
        k = key if p == 0 else jax.random.fold_in(key, p)
        for lo in range(0, n, BATCH):
            k, kb = jax.random.split(k)
            out[p, lo] = torch.from_numpy(np.array(
                jax.random.normal(kb, (BATCH, RR, LATENT))))
    return lambda p, lo: out[p, lo]


CASES = [("test_tail", "combined", 1, False),
         ("dev", "combined", 1, False),
         ("train_tail", "combined", 1, False),
         ("test_tail", "two_sided", 2, True)]


@pytest.mark.parametrize("source,detector,passes,vote", CASES)
def test_report_rows_match_jax(tiny, tmp_path, monkeypatch, source,
                               detector, passes, vote):
    run, jgan, jlogits, tgan, tlogits, sets = tiny
    data = _Data()
    calibrated = {}

    class Recording(jax_defense.DefendedPipeline):
        def calibrate(self, x, key=None, **kw):
            calibrated["jax"] = np.asarray(x)
            return super().calibrate(x, key, **kw)

    monkeypatch.setattr(jax_common, "load_gan",
                        lambda cfg, require_trained=False: jgan)
    monkeypatch.setattr(jax_common, "load_data", lambda cfg: data)
    monkeypatch.setattr(jax_classifier_mod, "load_cached_classifier",
                        lambda tag, model, shape: _State(jlogits))
    monkeypatch.setattr(jax_defense, "DefendedPipeline", Recording)
    args = ["--cfg", run, "--model", "A", "--sets", *sets,
            "--detector", detector, "--calib_source", source,
            "--calib_n", str(CALIB_N), "--eval_slice_n", str(EVAL_N),
            "--detect_passes", str(passes)] + (["--vote"] if vote else [])
    _jax_script("pipeline_exp").main(
        args + ["--results_dir", str(tmp_path / "jax")])
    ref = [json.loads(line) for line in
           open(tmp_path / "jax" / "pipeline.jsonl")]

    monkeypatch.setattr(pipeline_exp, "load_gan",
                        lambda cfg, device, require_trained: tgan)
    monkeypatch.setattr(pipeline_exp, "load_data", lambda cfg: data)
    monkeypatch.setattr(pipeline_exp, "load_cached_classifier",
                        lambda tag, model: _State(tlogits))
    draws = pipeline_exp.PipelineDraws(
        _jax_draws(jax.random.key(101), CALIB_N, passes),
        _jax_draws(jax.random.key(202), 10, passes))
    got = pipeline_exp.main(args + ["--device", "cpu", "--results_dir",
                                    str(tmp_path / "port")], draws=draws)
    assert got == [json.loads(line) for line in
                   open(tmp_path / "port" / "pipeline.jsonl")]

    x_calib, where = pipeline_exp.calibration_set(data, source, CALIB_N,
                                                  EVAL_N)
    np.testing.assert_array_equal(x_calib, calibrated["jax"])
    assert where == {"test_tail": ("test", 8, 20), "dev": ("dev", 0, 12),
                     "train_tail": ("train", 20, 32)}[source]
    assert [r["set"] for r in got] == ["clean", "set0", "set1"]
    for g, r in zip(got, ref):
        assert set(g) == set(r) | {"device"}
        assert g["device"]["type"] == "cpu"
        for k in r:
            if k in ("rec_err_mean", "margin_mean"):
                assert g[k] == pytest.approx(r[k], rel=1e-3), k
            else:
                assert g[k] == r[k], k
    # the rows are no constant: flag rates differ by set, some answers
    # right
    assert len({r["flag_rate"] for r in ref}) > 1
    assert any(0 < r["acc_all"] < 1 for r in ref)


def test_row_keys_hold_the_committed_jax_rows(tiny, tmp_path, monkeypatch):
    """The committed flagship rows (an older JAX script: no `vote`, no
    `rec_init`) hold a subset of the port's keys; the JAX script today
    writes exactly the port's keys but `device` (test above)."""
    committed = [json.loads(line) for line in
                 open(ROOT / "output" / "results" / "pipeline.jsonl")]
    flagship = [r for r in committed if r["set"].startswith("flagship")]
    assert flagship
    run, _, _, tgan, tlogits, sets = tiny
    monkeypatch.setattr(pipeline_exp, "load_gan",
                        lambda cfg, device, require_trained: tgan)
    monkeypatch.setattr(pipeline_exp, "load_data", lambda cfg: _Data())
    monkeypatch.setattr(pipeline_exp, "load_cached_classifier",
                        lambda tag, model: _State(tlogits))
    rows = pipeline_exp.main(["--cfg", run, "--sets", sets[0], "--device",
                              "cpu", "--calib_n", "8", "--eval_slice_n",
                              "8", "--results_dir", str(tmp_path)])
    for r in flagship:
        assert set(r) <= set(rows[0]) - {"device"}
    assert set(rows[0]) - set(flagship[0]) == {"vote", "rec_init",
                                               "device"}


def test_parser_has_every_jax_flag_and_device():
    ap = pipeline_exp.build_parser()
    port = {s for a in ap._actions for s in a.option_strings
            if s.startswith("--")} - {"--help"}
    assert _jax_flags("pipeline_exp.py") | {"--device"} == port
    a = ap.parse_args(["--cfg", "x", "--sets", "a.npz"])
    assert (a.model, a.fpr, a.detector, a.calib_n, a.detect_passes, a.vote,
            a.calib_source, a.eval_slice_n, a.override) == \
        ("A", 0.05, "two_sided", 256, 1, False, "test_tail", 256, [])
    # rows never go to the JAX package's output/results/
    assert (a.results_dir, a.device) == ("output/results_torch", "cuda")


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    """A tiny run with a weight export (generator and encoder), the
    classifier cache under tmp_path, a small stand-in dataset."""
    d = str(tmp_path / "run")
    save_config(Config(**_kw(d)))
    gan = DefenseGAN(Config(**_kw(d)), device="cpu")
    gan._build_encoder()
    gan.step = 5
    gan.write_export()
    monkeypatch.setattr(clf_cache, "CACHE_ROOT", str(tmp_path / "clf"))
    monkeypatch.setattr(pipeline_exp, "load_data", lambda cfg: _Data())
    return d


def test_override_serves_the_amortized_point(run_dir, tiny, tmp_path):
    clf_cache.save_classifier("mnist_modelE", ClassifierState(
        build_classifier("E", gen=torch.Generator().manual_seed(0))))
    rows = pipeline_exp.main([
        "--cfg", run_dir, "--model", "E", "--sets", *tiny[5], "--device",
        "cpu", "--calib_n", "8", "--eval_slice_n", "8", "--override",
        "REC_RR=3", "--override", "REC_ITERS=2", "--override",
        "REC_INIT=encoder", "--results_dir", str(tmp_path / "res")])
    assert len(rows) == 3
    for r in rows:
        assert (r["rec_rr"], r["rec_iters"], r["rec_init"]) == \
            (3, 2, "encoder")
        assert np.isfinite(r["rec_err_mean"])
    assert not (ROOT / "output" / "results" / "res").exists()


def test_refusals(run_dir, tiny, tmp_path):
    base = ["--cfg", run_dir, "--model", "E", "--sets", tiny[5][0],
            "--calib_n", "8", "--results_dir", str(tmp_path / "res")]
    with pytest.raises(SystemExit, match="no cached classifier"):
        pipeline_exp.main(base + ["--device", "cpu", "--eval_slice_n", "8"])
    clf_cache.save_classifier("mnist_modelE", ClassifierState(
        build_classifier("E", gen=torch.Generator().manual_seed(0))))
    with pytest.raises(SystemExit, match="all inside the attack-eval"):
        pipeline_exp.main(base + ["--device", "cpu", "--eval_slice_n",
                                  "24"])
    with pytest.raises(ValueError, match="detect_passes >= 2"):
        pipeline_exp.main(base + ["--device", "cpu", "--eval_slice_n", "8",
                                  "--vote"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline_exp.main(base + ["--eval_slice_n", "8"])
    empty = str(tmp_path / "empty")
    save_config(Config(**_kw(empty)))
    with pytest.raises(SystemExit, match="no trained GAN"):
        pipeline_exp.main(["--cfg", empty, "--sets", tiny[5][0],
                           "--device", "cpu"])
