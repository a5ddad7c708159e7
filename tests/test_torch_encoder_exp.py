"""The port's encoder-init frontier (defensegan_torch/cli/encoder_exp.py,
run by scripts/encoder_exp_torch.py) against the JAX script
(scripts/encoder_exp.py) on the CPU.

The JAX script's own main() runs one frontier cell (R 2, L 3, init
random, 8 images, FGSM 0.03 in two attack batches of 4), with its GAN,
data and classifier handed in (its loaders patched), on a tiny wide
generator (GEN_DIM 4, LATENT_DIM 16, float32), a JAX init bridged to the
port, and a fixed linear classifier on the image (the same numpy weights
on both sides). The port's main() runs the same cell with JAX's restart
draws passed through `FrontierDraws`: the detection passes' (key 11,
folded with 0 and 1, split per batch of 256) and the attack's
(sample_z0 of fold_in(key 23, lo) per attack batch). Held, with and
without the attack:
  - the adversarial images: equal where JAX's |d loss / dx| through the
    defense is above 1e-5 + 1e-3 of its largest element (the exact-target
    gradient bound of test_torch_attacks.py; below it float32 summation
    order may flip a sign), that is most elements;
  - the accuracies, both AUCs and the joint undetected rate: equal (counts
    over the same images);
  - the rec-err and margin means: within 1e-3 relative plus half a unit
    of the row's rounding;
  - row keys: the JAX row's plus `device`, and the committed JAX rows'
    (output/results/encoder_exp.jsonl) plus `device`.
The train leg runs on a copy of a tiny run (its cfg.yml pointed at the
copy: a run's cfg.yml names its own OUTPUT_DIR, where the leg writes) and
writes the encoder into that copy's export only; the refusals close the
file.
"""

import hashlib
import json
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import defensegan_tpu.cli.common as jax_common
import defensegan_tpu.eval.accuracy as jax_accuracy
from defensegan_tpu.attacks.compose import \
    make_attack_target as jax_target
from defensegan_tpu.attacks.fgsm import _xent as jax_xent
from defensegan_tpu.configs import Config as JaxConfig
from defensegan_tpu.configs import save_config as jax_save_config
from defensegan_tpu.defense.project import sample_z0 as jax_sample_z0
from defensegan_tpu.gan import DefenseGAN as JaxGAN
from defensegan_torch.attacks import attack_batch_key
from defensegan_torch.ckpt.bridge import load_flax_tree, read_export
from defensegan_torch.cli import encoder_exp
from defensegan_torch.configs import Config, load_config, save_config
from defensegan_torch.eval import classifier as clf_cache
from defensegan_torch.gan import DefenseGAN
from test_torch_pipeline_exp import _images, _jax_script, _kw, _State
from test_torch_serving_tools import _jax_flags

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LATENT, RR, ITERS, BATCH, N, ATTACK_BATCH = 16, 2, 3, 256, 8, 4
CELL = ["--grid", f"{RR}x{ITERS}", "--inits", "random", "--num_tests",
        str(N), "--attack_batch", str(ATTACK_BATCH), "--model", "A",
        "--fgsm_eps", "0.03"]
ROUNDING = {"rec_err_clean_mean": 1e-6, "margin_clean_mean": 1e-3,
            "rec_err_adv_mean": 1e-6}
TIMES = {"recon_per_s", "craft_s"}


class _Data:
    def __init__(self, labels=None):
        self.labels = labels

    def load(self, split):
        n = {"train": 32, "dev": 16, "test": 12}[split]
        y = np.arange(n, dtype=np.int32) % 10
        if split == "test" and self.labels is not None:
            y = self.labels(_images(n, n))
        return _images(n, n), y


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    base = tmp_path_factory.mktemp("enc")
    run = str(base / "run")
    jax_save_config(JaxConfig(**_kw(run)))
    jgan = JaxGAN(JaxConfig(**_kw(run)), key=jax.random.key(4))
    tgan = DefenseGAN(Config(**_kw(run)), device="cpu")
    load_flax_tree(tgan.generator,
                   jax.tree.map(np.asarray, jgan.state.gen_params),
                   jax.tree.map(np.asarray, jgan.state.gen_stats))
    w = np.random.RandomState(8).randn(784, 10).astype(np.float32) * 20.0

    def jlogits(x):
        return (jnp.reshape(x, (x.shape[0], -1)) - 0.5) @ w

    def tlogits(x):
        x = torch.as_tensor(x)
        return (x.reshape(x.shape[0], -1) - 0.5) @ torch.from_numpy(w)

    # labels: the classifier's answers on the purified clean images (the
    # clean pass's draws), so that clean-defended accuracy is 1 and the
    # attack has something to move
    def labels(x):
        with torch.no_grad():
            res = tgan.reconstruct(x, z0=_feature_draws()(0, 0)[:len(x)])
            return tlogits(res.x_hat).argmax(-1).numpy().astype(np.int32)
    return run, jgan, jlogits, tgan, tlogits, _Data(labels)


def _feature_draws():
    """JAX's detection-pass z0: fold_in(key 11, p), split per batch."""
    out = {}
    for p in (0, 1):
        k = jax.random.fold_in(jax.random.key(11), p)
        for lo in range(0, N, BATCH):
            k, kb = jax.random.split(k)
            out[p, lo] = torch.from_numpy(np.array(
                jax.random.normal(kb, (BATCH, RR, LATENT))))
    return lambda p, lo: out[p, lo]


def _attack_keys():
    """port seed -> JAX key of each attack batch."""
    return {attack_batch_key(encoder_exp.ATTACK_SEED, lo):
            jax.random.fold_in(jax.random.key(23), lo)
            for lo in range(0, N, ATTACK_BATCH)}


def _attack_draws():
    table = {s: torch.from_numpy(np.array(jax_sample_z0(
        k, ATTACK_BATCH, RR, LATENT))) for s, k in _attack_keys().items()}
    return lambda x, key: table[key]


def _run_both(tiny, tmp_path, monkeypatch, extra):
    run, jgan, jlogits, tgan, tlogits, data = tiny
    seen = []
    model_eval = jax_accuracy.model_eval

    def recording_eval(fn, x, y, *a, **kw):
        seen.append(np.asarray(x))
        return model_eval(fn, x, y, *a, **kw)
    monkeypatch.setattr(jax_common, "load_gan",
                        lambda cfg, require_trained=False: jgan)
    monkeypatch.setattr(jax_common, "load_data", lambda cfg: data)
    monkeypatch.setattr(jax_accuracy, "model_eval", recording_eval)
    mod = _jax_script("encoder_exp")
    monkeypatch.setattr(mod, "get_or_train_classifier",
                        lambda cfg, name, x, y: _State(jlogits))
    mod.main(["--cfg", run, "--results_dir", str(tmp_path / "jax")]
             + CELL + extra)
    ref = [json.loads(line) for line in
           open(tmp_path / "jax" / "encoder_exp.jsonl")]

    monkeypatch.setattr(encoder_exp, "load_gan",
                        lambda cfg, device, require_trained: tgan)
    monkeypatch.setattr(encoder_exp, "load_data", lambda cfg: data)
    monkeypatch.setattr(encoder_exp, "get_or_train_classifier",
                        lambda cfg, name, x, y, device: _State(tlogits))
    got = encoder_exp.main(
        ["--cfg", run, "--device", "cpu", "--results_dir",
         str(tmp_path / "port")] + CELL + extra,
        draws=encoder_exp.FrontierDraws(_feature_draws(), _attack_draws()))
    written = [json.loads(line) for line in
               open(tmp_path / "port" / "encoder_exp.jsonl")]
    assert written == got["frontier"] and got["train"] is None
    return ref, got, seen


def _rows_equal(got, ref):
    assert set(got) == set(ref) | {"device"}
    for k, v in ref.items():
        if k in TIMES:           # wall times, rounded to 0.1 s and 0.1/s
            assert got[k] >= 0
        elif k in ROUNDING:
            assert abs(got[k] - v) <= 1e-3 * abs(v) + ROUNDING[k] / 2, k
        else:
            assert got[k] == v, k


def test_frontier_cell_with_fgsm_matches_jax(tiny, tmp_path, monkeypatch):
    ref, got, seen = _run_both(tiny, tmp_path, monkeypatch, [])
    (r,), (g,) = ref, got["frontier"]
    _rows_equal(g, r)
    # no constant row: the attack moves some purified answers, and the
    # detector tells some clean images from adversarial ones
    assert r["defended_acc"] < r["clean_defended_acc"] == 1.0
    assert 0.5 < r["detection_auc_combined"] < 1.0
    # the JAX script evaluates the bare classifier on x, then on x_adv
    x_test = seen[0]
    x_adv_ref = seen[1]
    x_adv = got["x_adv"][(RR, ITERS, "random")]
    # JAX's d mean-xent / dx through the defense, per attack batch
    run, jgan, jlogits, _, _, data = tiny
    _, y = data.load("test")
    target = jax_target(jgan, jlogits, jgan.cfg)
    grads = []
    for lo in range(0, N, ATTACK_BATCH):
        k = jax.random.fold_in(jax.random.key(23), lo)
        yb = jnp.asarray(y[lo:lo + ATTACK_BATCH])
        grads.append(np.asarray(jax.grad(lambda xx: jnp.mean(jax_xent(
            target(xx, k), yb)))(jnp.asarray(x_test[lo:lo + ATTACK_BATCH]))))
    g_ref = np.concatenate(grads)
    keep = np.abs(g_ref) > 1e-5 + 1e-3 * np.abs(g_ref).max()
    assert keep.mean() > 0.5
    np.testing.assert_allclose(x_adv[keep], x_adv_ref[keep], atol=1e-6)
    assert np.abs(x_adv - x_test).max() > 0.029           # it moved
    # the committed JAX frontier rows have the same keys
    committed = [json.loads(line) for line in
                 open(ROOT / "output" / "results" / "encoder_exp.jsonl")]
    front = [c for c in committed if c["leg"] == "frontier"
             and "defended_acc" in c]
    assert front and all(set(c) | {"device"} == set(g) for c in front)


def test_frontier_cell_without_attack_matches_jax(tiny, tmp_path,
                                                  monkeypatch):
    ref, got, _ = _run_both(tiny, tmp_path, monkeypatch, ["--skip_attack"])
    (r,), (g,) = ref, got["frontier"]
    _rows_equal(g, r)
    assert "defended_acc" not in g
    assert got["x_adv"][(RR, ITERS, "random")] is None
    assert encoder_exp.summary_table(got["frontier"], True).splitlines()[1]\
        .split()[-2:] == [f"{g['clean_defended_acc']:.3f}",
                          f"{g['recon_per_s']:.1f}"]


def test_parser_has_every_jax_flag_and_device():
    ap = encoder_exp.build_parser()
    port = {s for a in ap._actions for s in a.option_strings
            if s.startswith("--")} - {"--help"}
    assert _jax_flags("encoder_exp.py") | {"--device"} == port
    a = ap.parse_args(["--cfg", "x"])
    assert (a.model, a.legs, a.grid, a.inits, a.num_tests, a.fgsm_eps,
            a.attack_batch, a.encoder_iters, a.noise_aug, a.skip_attack) \
        == ("A", ["frontier"], ["10x200", "4x100", "2x50", "1x25"],
            ["random", "encoder", "encoder_jitter"], 256, 0.3, 128, None,
            None, False)
    assert (a.results_dir, a.device) == ("output/results_torch", "cuda")


def _sha(path):
    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


@pytest.fixture
def port_run(tmp_path, monkeypatch):
    """A tiny run with a generator-only weight export, the classifier
    cache under tmp_path, a small stand-in dataset."""
    d = tmp_path / "run"
    save_config(Config(**_kw(str(d))))
    gan = DefenseGAN(Config(**_kw(str(d))), device="cpu")
    gan.step = 9
    gan.write_export()
    monkeypatch.setattr(clf_cache, "CACHE_ROOT", str(tmp_path / "clf"))
    monkeypatch.setattr(encoder_exp, "load_data", lambda cfg: _Data())
    return d


def test_train_leg_writes_the_copy_only(port_run, tmp_path):
    export = port_run / "export" / "9.npz"
    before = _sha(export)
    copy = tmp_path / "copy"
    shutil.copytree(port_run, copy)
    # a run's cfg.yml names its own OUTPUT_DIR, where the leg writes: the
    # copy's must name the copy
    save_config(load_config(str(copy)).replace(output_dir=str(copy)))
    out = encoder_exp.main([
        "--cfg", str(copy), "--device", "cpu", "--legs", "train",
        "frontier", "--encoder_iters", "3", "--grid", "2x2", "--inits",
        "encoder", "encoder_jitter", "--num_tests", "4", "--attack_batch",
        "4", "--results_dir", str(tmp_path / "res")])
    assert _sha(export) == before
    assert "encoder" not in read_export(str(export))
    assert "encoder" in read_export(str(copy / "export" / "9.npz"))
    committed = [json.loads(line) for line in
                 open(ROOT / "output" / "results" / "encoder_exp.jsonl")]
    train = [c for c in committed if c["leg"] == "train"]
    assert train and set(out["train"]) == set(train[0]) | {"device"}
    assert out["train"]["iters"] == 3 and out["train"]["gen_step"] == 9
    assert np.isfinite(out["train"]["img_mse"])
    # the frontier through the new encoder: the attack differentiates
    # through it, the rows are finite
    assert [r["rec_init"] for r in out["frontier"]] == ["encoder",
                                                        "encoder_jitter"]
    for r in out["frontier"]:
        assert np.isfinite(r["rec_err_adv_mean"])
        assert 0.0 <= r["detection_auc_combined"] <= 1.0
    assert (tmp_path / "clf" / "mnist_modelA").is_dir()   # trained, cached


def test_refusals(port_run, tmp_path):
    base = ["--cfg", str(port_run), "--grid", "2x2", "--num_tests", "4",
            "--skip_attack", "--results_dir", str(tmp_path / "res")]
    with pytest.raises(SystemExit, match="no trained encoder"):
        encoder_exp.main(base + ["--device", "cpu", "--inits", "encoder"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encoder_exp.main(base + ["--inits", "random"])
    empty = str(tmp_path / "empty")
    save_config(Config(**_kw(empty)))
    with pytest.raises(SystemExit, match="no trained GAN"):
        encoder_exp.main(["--cfg", empty, "--device", "cpu"])
