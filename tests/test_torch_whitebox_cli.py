"""The port's white-box CLI (whitebox_torch.py -> defensegan_torch/cli/
whitebox.py) end to end on the CPU.

A tiny run is made in tmp_path: a narrow wide generator (GEN_DIM 4,
LATENT_DIM 16, float32) initialized by the JAX package, written as the
run's numpy weight export (the "trained" mark the port loads), with its
cfg.yml at R 2, L 3. Each attack type runs on 8 synthetic test images
with one classifier epoch (the classifier cache under the test's own
working directory); the results row must carry every key of the JAX
CLI's row plus `device` and `package`. A --load_adv replay of the first
8 rows of the committed flagship SPSA set runs on the committed flagship
export, and a run whose GAN has no export is refused.
"""

import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from defensegan_tpu.configs import Config as JaxConfig
from defensegan_tpu.gan import DefenseGAN as JaxGAN
from defensegan_torch.configs import Config, save_config

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ADVSET = ROOT / "output" / "advsets" / "flagship_conf_l300.npz"

# the JAX CLI's results row (defensegan_tpu/cli/whitebox.py `record`)
JAX_KEYS = {
    "script", "dataset", "model", "attack", "load_adv", "adv_meta",
    "detect_passes", "defense", "fgsm_eps", "num_tests", "rec_rr",
    "rec_iters", "rec_init", "attack_rec_iters", "attack_eot_keys",
    "attack_batch", "cw_max_iterations", "cw_binary_search_steps",
    "cw_abort_early", "pgd_iters", "pgd_eps_iter", "pgd_rand_init",
    "pgd_z0", "pgd_rec_penalty", "pgd_rec_center", "spsa_iters",
    "spsa_samples", "spsa_delta", "spsa_lr", "spsa_rec_penalty",
    "spsa_rec_center", "spsa_center_quantiles", "spsa_objective",
    "spsa_margin_kappa", "attack_through_defense", "attack_grad",
    "attack_z0", "eval_z0", "train_on_recs", "clean_acc",
    "clean_defended_acc", "adv_acc_no_defense", "defended_acc",
    "defended_acc_attack_z0", "detection_auc", "detection_tpr_at_fpr05",
    "detection_auc_two_sided", "detection_tpr_at_fpr05_two_sided",
    "detection_auc_combined", "detection_tpr_at_fpr05_combined",
    "undetected_success_rate", "undetected_success_rate_two_sided",
    "undetected_success_rate_combined", "margin_clean_mean",
    "margin_adv_mean", "rec_err_clean_mean", "rec_err_adv_mean",
    "attack_time_s", "phases"}


def _flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def make_tiny_run(run_dir: str, export: bool = True) -> str:
    kw = dict(type="mnist", gen_arch="wide", gen_dim=4, disc_dim=4,
              latent_dim=16, rec_rr=2, rec_iters=3,
              compute_dtype="float32", output_dir=run_dir)
    save_config(Config(**kw))
    if export:
        jgan = JaxGAN(JaxConfig(**kw))
        arrays = _flatten(jgan.state.gen_params, "generator/params")
        arrays.update(_flatten(jgan.state.gen_stats,
                               "generator/batch_stats"))
        os.makedirs(os.path.join(run_dir, "export"))
        np.savez(os.path.join(run_dir, "export", "1.npz"), **arrays)
    return run_dir


def _whitebox():
    spec = importlib.util.spec_from_file_location(
        "whitebox_torch", ROOT / "whitebox_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return make_tiny_run(str(tmp_path_factory.mktemp("tiny") / "run"))


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)        # the classifier cache and results
    return tmp_path


BASE = ["--device", "cpu", "--model", "E", "--num_tests", "8",
        "--attack_batch", "4", "--classifier_epochs", "1",
        "--fgsm_eps", "0.3"]


@pytest.mark.parametrize("attack,extra", [
    ("fgsm", []),
    ("fgsm", ["--attack_grad", "bpda", "--detect"]),
    ("rand_fgsm", ["--eval_z0", "both"]),
    ("pgd", ["--pgd_iters", "2", "--attack_grad", "bpda"]),
    ("pgd", ["--pgd_iters", "2", "--pgd_z0", "fixed",
             "--pgd_rec_penalty", "1.0", "--pgd_rec_center", "0.03"]),
    ("cw", ["--cw_max_iterations", "3", "--cw_binary_search_steps", "2",
            "--attack_eot_keys", "2"]),
    ("cw", ["--cw_max_iterations", "4", "--cw_binary_search_steps", "1",
            "--cw_abort_early", "--attack_through_defense", "no"]),
    ("spsa", ["--spsa_iters", "2", "--spsa_samples", "4",
              "--spsa_chunk", "2", "--detect"]),
    ("fgsm", ["--train_on_recs", "--num_rec_train", "16"]),
    ("fgsm", ["--defense_type", "adv_tr"]),
    ("none", ["--defense_type", "none"]),
])
def test_each_attack_type_runs_end_to_end(run, in_tmp, attack, extra):
    rec = _whitebox().main(["--cfg", run, "--attack_type", attack]
                           + BASE + extra)
    assert JAX_KEYS <= set(rec)
    assert rec["package"] == "defensegan_torch"
    assert rec["device"]["type"] == "cpu"
    assert rec["num_tests"] == 8 and 0.0 <= rec["clean_acc"] <= 1.0
    if rec["defense"] == "defense_gan":
        # the CPU resolves `auto` to the packed plain path
        assert set(rec["last_kernel"].values()) == {"packed"}
        assert 0.0 <= rec["defended_acc"] <= 1.0
    if "--detect" in extra:
        assert 0.0 <= rec["detection_auc"] <= 1.0
    if "--eval_z0" in extra:
        assert rec["defended_acc_attack_z0"] is not None
    with open(in_tmp / "output" / "results_torch" / "whitebox.jsonl") as f:
        assert json.loads(f.readline())["attack"] == attack
    tag = "mnist_modelE" + ("_advtr0.3" if "adv_tr" in extra else "") \
        + ("_on_recs" if "--train_on_recs" in extra else "")
    assert (in_tmp / "output" / "classifiers_torch" / tag / "checkpoints" /
            "0.pt").exists()
    assert not (in_tmp / "output" / "results").exists()
    assert not (in_tmp / "output" / "classifiers").exists()


def test_classifier_cache_round_trip(run, in_tmp):
    wb = _whitebox()
    a = wb.main(["--cfg", run, "--attack_type", "none", "--defense_type",
                 "none"] + BASE)
    b = wb.main(["--cfg", run, "--attack_type", "none", "--defense_type",
                 "none"] + BASE)
    assert a["clean_acc"] == b["clean_acc"]
    assert b["phases"]["train_classifier"]["total_s"] < \
        a["phases"]["train_classifier"]["total_s"] + 1.0


def test_save_adv_then_replay(run, in_tmp):
    wb = _whitebox()
    path = str(in_tmp / "adv.npz")
    wb.main(["--cfg", run, "--attack_type", "fgsm", "--save_adv", path,
             "--defense_type", "none"] + BASE)
    rec = wb.main(["--cfg", run, "--attack_type", "none", "--load_adv",
                   path, "--detect", "--detect_passes", "2",
                   "--detect_save", str(in_tmp / "det.npz")] + BASE)
    assert rec["attack"] == "fgsm_replay"
    with np.load(in_tmp / "det.npz") as d:
        assert d["errs_clean_pp"].shape == (2, 8)


def test_load_adv_replay_of_committed_flagship_set(in_tmp):
    """The committed flagship export at R 2, L 2 replays the first 8 rows
    of the JAX package's adversarial set with --detect."""
    run = str(ROOT / "output" / "gans" / "mnist_fast")
    rec = _whitebox().main([
        "--cfg", str(ROOT / "defensegan_torch" / "configs" / "gans" /
                     "mnist_fast.yml"), "--output_dir", run,
        "--override", "COMPUTE_DTYPE=float32", "--rec_rr", "2",
        "--rec_iters", "2", "--attack_type", "none", "--load_adv",
        str(ADVSET), "--detect", "--detect_save",
        str(in_tmp / "det.npz")] + BASE)
    assert rec["attack"] == "spsa_replay" and rec["num_tests"] == 8
    assert rec["adv_meta"]["spsa_objective"] == "confident"
    with np.load(in_tmp / "det.npz") as d:
        assert d["errs_clean"].shape == d["errs_adv"].shape == (8,)
        assert np.isfinite(d["errs_clean"]).all()
        meta = json.loads(str(d["meta"]))
    assert meta["replayed_from"] == str(ADVSET)
    with np.load(ADVSET) as s:
        # the replayed clean images are the set's own
        assert s["x_clean"].shape[0] == 128


def test_untrained_gan_is_refused(tmp_path, in_tmp):
    run = make_tiny_run(str(tmp_path / "untrained"), export=False)
    with pytest.raises(SystemExit, match="no trained GAN"):
        _whitebox().main(["--cfg", run, "--attack_type", "fgsm"] + BASE)
    # without the defense or the detector the GAN is not used
    rec = _whitebox().main(["--cfg", run, "--attack_type", "fgsm",
                            "--defense_type", "none"] + BASE)
    assert rec["defended_acc"] is None


def test_flag_rules_match_jax(run):
    wb = _whitebox()
    for bad in (["--attack_type", "rand_fgsm", "--alpha", "0.5"],
                ["--attack_type", "fgsm", "--load_adv", "x.npz"],
                ["--attack_type", "spsa", "--attack_grad", "bpda"],
                ["--attack_type", "none", "--detect"]):
        with pytest.raises(SystemExit):
            wb.main(["--cfg", run] + BASE + bad)


def test_cuda_device_without_a_card_raises(run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _whitebox().main(["--cfg", run, "--attack_type", "none",
                          "--defense_type", "none", "--num_tests", "2"])


def test_save_images_and_adv_pngs_match_jax_grid(run, in_tmp):
    """--save_images writes the original | adversarial | purified grid the
    JAX CLI writes: recomputed here (the purified images from the CLI's own
    seed, fold_seed(k_eval, 99)) and saved with the JAX package's
    save_images, the two PNGs decode equal pixel for pixel.
    --save_adv_pngs writes each original and adversarial image beside the
    npz."""
    from PIL import Image

    from defensegan_torch.configs import load_config
    from defensegan_torch.gan import DefenseGAN
    from defensegan_torch.utils.misc import fold_seed, generator_for
    from defensegan_tpu.utils.visualize import save_images as jax_save

    adv = in_tmp / "adv.npz"
    _whitebox().main(["--cfg", run, "--attack_type", "fgsm", "--save_adv",
                      str(adv), "--save_adv_pngs", "--save_images",
                      "--results_dir", str(in_tmp / "res")] + BASE)
    pngs = sorted(p.name for p in (in_tmp / "adv_pngs").iterdir())
    assert len(pngs) == 16 and pngs[0].startswith("adv_00000_")
    with np.load(adv) as d:
        x_clean, x_adv = d["x_clean"], d["x_adv"]
    gan = DefenseGAN(load_config(run), device="cpu").load()
    k_eval = fold_seed(fold_seed(gan.cfg.seed + 7, 2), 99)
    purified = gan.reconstruct(x_adv, generator_for(k_eval, "cpu")) \
        .x_hat.numpy()
    trio = np.stack([x_clean, x_adv, purified], 1).reshape(
        (-1,) + x_clean.shape[1:])
    ref = jax_save(trio, str(in_tmp / "jax.png"), grid=(8, 3))
    got = in_tmp / "res" / "whitebox_mnist_fgsm.png"
    np.testing.assert_array_equal(np.asarray(Image.open(got)),
                                  np.asarray(Image.open(ref)))
    assert len(list((in_tmp / "res" / "whitebox_mnist_fgsm_pngs")
                    .iterdir())) == 24
