"""The port's black-box CLI (blackbox_torch.py -> defensegan_torch/cli/
blackbox.py) end to end on the CPU.

The GAN is one the port trains here (2 steps of the wide MNIST generator
at GEN_DIM 4, LATENT_DIM 16, float32) and serves at R 2, L 3. Each run
trains the target one epoch (model E) and the substitute over 2 rounds
from the first 150 test images, and evaluates 16 images: the results row
must carry every key of the JAX CLI's row plus `device`, `package` and
`last_kernel` (the CPU resolves `auto` to the packed plain path), and go
to output/results_torch/blackbox.jsonl; --detect_save writes the JAX
CLI's npz layout. The defense and --train_on_recs refuse a run with no
weight export, and without --device cpu the CLI asks for the card.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from defensegan_torch.configs import Config, save_config
from defensegan_torch.gan import DefenseGAN

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the JAX CLI's results row (defensegan_tpu/cli/blackbox.py `record`)
JAX_KEYS = {
    "script", "dataset", "bb_model", "sub_model", "defense", "fgsm_eps",
    "data_aug", "lmbda", "train_on_recs", "sub_from_scratch", "num_tests",
    "clean_acc", "sub_agreement", "clean_defended_acc",
    "adv_acc_no_defense", "defended_acc", "detection_auc",
    "detection_tpr_at_fpr05", "detection_auc_two_sided",
    "detection_tpr_at_fpr05_two_sided", "detection_auc_combined",
    "detection_tpr_at_fpr05_combined", "undetected_success_rate",
    "undetected_success_rate_two_sided", "undetected_success_rate_combined",
    "rec_err_clean_mean", "rec_err_adv_mean", "phases"}

BASE = ["--device", "cpu", "--bb_model", "E", "--sub_model", "E",
        "--num_tests", "16", "--data_aug", "2", "--classifier_epochs", "1",
        "--sub_epochs", "1"]


def _cfg(run, **kw):
    return Config(type="mnist", gen_arch="wide", gen_dim=4, disc_dim=4,
                  latent_dim=16, batch_size=8, disc_iters=1, rec_rr=2,
                  rec_iters=3, compute_dtype="float32",
                  output_dir=str(run), save_every=2, sample_every=0, **kw)


def _blackbox():
    spec = importlib.util.spec_from_file_location(
        "blackbox_torch", ROOT / "blackbox_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    run = tmp_path_factory.mktemp("bb") / "run"
    data = np.random.RandomState(0).rand(32, 28, 28, 1).astype(np.float32)
    DefenseGAN(_cfg(run), device="cpu").train(data, train_iters=2,
                                              quiet=True)
    return str(run)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)        # the results go under output/
    return tmp_path


@pytest.mark.parametrize("extra", [
    ["--detect", "--detect_save", "det.npz"],
    ["--defense_type", "none"],
    ["--defense_type", "adv_tr"],
    ["--sub_from_scratch", "--train_on_recs", "--num_rec_train", "16"],
])
def test_row_has_the_jax_keys(run, in_tmp, extra):
    rec = _blackbox().main(["--cfg", run] + BASE + extra)
    assert JAX_KEYS <= set(rec)
    assert rec["package"] == "defensegan_torch"
    assert rec["device"]["type"] == "cpu" and rec["num_tests"] == 16
    assert 0.0 <= rec["clean_acc"] <= 1.0
    assert 0.0 <= rec["sub_agreement"] <= 1.0
    defense = rec["defense"]
    if defense == "defense_gan":
        assert set(rec["last_kernel"].values()) == {"packed"}
        assert 0.0 <= rec["defended_acc"] <= 1.0
    elif defense == "adv_tr":
        assert rec["defended_acc"] == rec["adv_acc_no_defense"]
    else:
        assert rec["defended_acc"] is None and rec["last_kernel"] == {}
    if "--train_on_recs" in extra:
        assert rec["last_kernel"]["reconstruct_train"] == "packed"
    with open(in_tmp / "output" / "results_torch" / "blackbox.jsonl") as f:
        assert json.loads(f.readline())["bb_model"] == "E"
    if "--detect" in extra:
        assert 0.0 <= rec["detection_auc"] <= 1.0
        with np.load(in_tmp / "det.npz") as d:
            assert set(d.files) == {
                "errs_clean", "errs_adv", "margins_clean", "margins_adv",
                "all_losses_clean", "all_losses_adv",
                "defended_correct_adv", "meta"}
            assert d["all_losses_adv"].shape == (16, 2)
            assert json.loads(str(d["meta"]))["script"] == "blackbox"
    assert not (in_tmp / "output" / "results").exists()


def test_untrained_gan_is_refused(tmp_path, in_tmp):
    untrained = tmp_path / "untrained"
    save_config(_cfg(untrained))
    bb = _blackbox()
    for extra in ([], ["--defense_type", "none", "--train_on_recs"]):
        with pytest.raises(SystemExit, match="no trained GAN"):
            bb.main(["--cfg", str(untrained)] + BASE + extra)
    with pytest.raises(SystemExit):     # argparse: --detect needs the GAN
        bb.main(["--cfg", str(untrained), "--detect", "--defense_type",
                 "none"] + BASE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bb.main(["--cfg", str(untrained), "--defense_type", "none"])
