"""The port's training CLI (train_torch.py -> defensegan_torch/cli/
train.py) end to end on the CPU.

A tiny run (wide MNIST generator at GEN_DIM 4, critic at DISC_DIM 4,
LATENT_DIM 16, float32, B 8, DISC_ITERS 2, 4 steps on the synthetic
stand-in data, samples and saves every 2 steps) must write cfg.yml,
metrics.jsonl, the sample grids, the checkpoints and the weight exports;
test mode must write the sample grid, the original | reconstruction grid
and with --save_recs_files one PNG per image; --train_encoder must put
the encoder into the export. A second --is_train resumes from the
checkpoint. Test mode and a standalone --train_encoder refuse a run with
no export, --is_train refuses a run with an export and no checkpoint,
and without --device cpu the CLI asks for the card.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

from defensegan_torch.configs import Config, save_config

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--batch_size", "8",
        "--override", "GEN_DIM=4", "--override", "DISC_DIM=4",
        "--override", "LATENT_DIM=16", "--override", "DISC_ITERS=2",
        "--override", "COMPUTE_DTYPE=float32", "--override", "SAVE_EVERY=2",
        "--override", "SAMPLE_EVERY=2", "--override", "REC_RR=2",
        "--override", "REC_ITERS=3", "--override", "ENCODER_BATCH=8",
        "--override", "ENCODER_TRAIN_ITERS=4"]


def _train_cli():
    spec = importlib.util.spec_from_file_location(
        "train_torch", ROOT / "train_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg_yml():
    return str(ROOT / "defensegan_torch" / "configs" / "gans" /
               "mnist_fast.yml")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    run = tmp_path_factory.mktemp("train") / "run"
    out = _train_cli().main(["--cfg", _cfg_yml(), "--is_train",
                             "--output_dir", str(run), "--train_iters", "4"]
                            + TINY)
    return run, out


def test_training_writes_the_run(trained):
    run, out = trained
    assert np.isfinite(out["g_loss"]) and out["train_steps_per_s"] > 0
    assert (run / "cfg.yml").exists()
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert rows[-1]["step"] == 4
    for step in (2, 4):
        assert (run / "checkpoints" / f"{step}.pt").exists()
        assert (run / "export" / f"{step}.npz").exists()
        assert (run / "export" / f"{step}.json").exists()
        grid = np.asarray(Image.open(run / "samples" /
                                     f"sample_{step:07d}.png"))
        assert grid.shape == (8 * 28, 8 * 28) and grid.dtype == np.uint8
    with np.load(run / "export" / "4.npz") as z:
        assert "generator/batch_stats/bn_in/var" in z.files
        assert "critic/params/fc_out/kernel" in z.files
    manifest = json.load(open(run / "export" / "4.json"))
    assert manifest["step"] == 4 and manifest["package"] == \
        "defensegan_torch"


def test_test_mode_and_standalone_encoder(trained):
    run, _ = trained
    cli = _train_cli()
    out = cli.main(["--cfg", str(run), "--num_recs", "4",
                    "--save_recs_files", "--device", "cpu"])
    assert out["step"] == 4 and out["last_kernel"] == "packed"
    assert out["rec_loss"].shape == (4,)
    assert np.asarray(Image.open(run / "test_samples.png")).shape == \
        (8 * 28, 8 * 28)
    assert np.asarray(Image.open(run / "test_reconstructions.png")).shape \
        == (4 * 28, 2 * 28)
    assert len(list((run / "recs").glob("*.png"))) == 8
    m = cli.main(["--cfg", str(run), "--train_encoder", "--device", "cpu"])
    assert [h["step"] for h in m["encoder"]["history"]] == [4]
    with np.load(run / "export" / "4.npz") as z:
        assert "encoder/params/fc_z/kernel" in z.files


def test_second_run_resumes_from_the_checkpoint(trained, capsys):
    run, _ = trained
    _train_cli().main(["--cfg", str(run), "--is_train", "--train_iters",
                       "6", "--device", "cpu"])
    assert "resuming from checkpoint step 4" in capsys.readouterr().out
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert [r["step"] for r in rows][-1] == 6
    assert (run / "checkpoints" / "6.pt").exists()


def test_refusals(tmp_path):
    cli = _train_cli()
    untrained = tmp_path / "untrained"
    save_config(Config(type="mnist", gen_arch="wide", gen_dim=4,
                       disc_dim=4, latent_dim=16, compute_dtype="float32",
                       output_dir=str(untrained)))
    with pytest.raises(SystemExit, match="no trained GAN"):
        cli.main(["--cfg", str(untrained), "--device", "cpu"])
    with pytest.raises(SystemExit, match="no trained GAN"):
        cli.main(["--cfg", str(untrained), "--train_encoder", "--device",
                  "cpu"])
    # the committed flagship has an export and no torch checkpoint:
    # training into it would overwrite the export
    with pytest.raises(SystemExit, match="no training checkpoint"):
        cli.main(["--cfg", _cfg_yml(), "--is_train", "--output_dir",
                  str(ROOT / "output" / "gans" / "mnist_fast"),
                  "--train_iters", "1"] + TINY)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--cfg", str(untrained), "--is_train"])
