"""The port's int8-validation and serving-latency tools
(defensegan_torch/cli/int8_validate.py, cli/serving_bench.py, run by
scripts/int8_validate_torch.py and scripts/serving_bench_torch.py) on the
CPU, on a tiny trained-looking run: argument parsing (every flag of the
JAX scripts, plus --device), the stamp and the rows (the JAX scripts'
keys plus the device record), where they go, and the refusals. On the
CPU the kernel requests run their plain paths; the numbers are path
checks."""

import json
import pathlib
import re

import numpy as np
import pytest
import torch

from defensegan_torch.cli import int8_validate, serving_bench
from defensegan_torch.configs import Config, save_config
from defensegan_torch.eval import classifier as clf_cache
from defensegan_torch.eval.quality import int8_gate_ok
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.models import build_classifier

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the JAX scripts' stamp (scripts/int8_validate.py) and row
# (scripts/serving_bench.py) keys
JAX_STAMP_KEYS = {
    "step", "pass", "material_disagreement_int8",
    "material_disagreement_bf16", "best_loss_absdiff_p95",
    "best_loss_absdiff_p95_bf16_control", "recon_shift_mse_int8",
    "recon_shift_mse_bf16", "recon_residual_mse_xla", "criterion"}
JAX_METRIC_KEYS = {
    "argmin_agreement_int8_vs_xla", "argmin_agreement_bf16_vs_xla",
    "material_disagreement_int8_vs_xla",
    "material_disagreement_bf16_vs_xla", "mean_regret_int8",
    "mean_regret_bf16", "tie_tau", "best_loss_mean_xla",
    "best_loss_mean_int8", "best_loss_mean_bf16",
    "best_loss_absdiff_p95_int8", "best_loss_absdiff_p95_bf16",
    "recon_shift_mse_int8", "recon_shift_mse_bf16",
    "recon_residual_mse_xla"}
JAX_ROW_KEYS = {
    "script", "dataset", "model", "batch", "kernel", "rec_rr", "rec_iters",
    "rec_init", "detector", "detect_passes", "latency_ms_min",
    "latency_ms_median", "images_per_s", "clean_flag_rate", "repeats",
    "sharded", "clf_dtype", "clf_bf16_disagree", "input_dtype"}
TINY = ["--device", "cpu", "--rec_iters", "3"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A wide flagship-shaped run at GEN_DIM 4 with a weight export."""
    d = str(tmp_path_factory.mktemp("tools") / "run")
    cfg = Config(type="mnist", gen_arch="wide", gen_dim=4, disc_dim=4,
                 latent_dim=16, rec_rr=2, rec_iters=3,
                 compute_dtype="bfloat16", output_dir=d)
    save_config(cfg)
    gan = DefenseGAN(cfg, device="cpu")
    gan.step = 7
    gan.write_export()
    return d


def _jax_flags(script: str):
    """The flags the JAX script declares (its --help cannot print: a help
    string holds a bare '%')."""
    src = (ROOT / "scripts" / script).read_text()
    return set(re.findall(r'add_argument\(\s*"(--\w+)"', src))


def _port_flags(parser):
    return {s for a in parser._actions for s in a.option_strings
            if s.startswith("--")} - {"--help"}


def test_serving_bench_has_every_jax_flag_and_device():
    port = _port_flags(serving_bench.build_parser())
    assert _jax_flags("serving_bench.py") | {"--device"} == port


def test_parser_defaults():
    a = int8_validate.build_parser().parse_args([])
    assert (a.cfg, a.out, a.batch, a.bench_batches, a.repeats, a.device) \
        == (int8_validate.FLAGSHIP_CFG, None, 256, [4096, 16384], 3, "cuda")
    b = serving_bench.build_parser().parse_args(["--cfg", "x"])
    assert (b.batches, b.repeats, b.results_dir, b.device, b.model) == \
        ([1, 16, 256, 1024, 4096, 16384], 3, "output/results_torch",
         "cuda", "A")


def test_int8_validate_writes_the_stamp_beside_the_export(run):
    out = int8_validate.main(["--cfg", run, "--batch", "8",
                              "--bench_batches", "4", "--repeats", "1"]
                             + TINY)
    path = pathlib.Path(run) / "export" / "int8_gate_cuda.json"
    assert out["stamp_path"] == str(path)
    stamp = json.loads(path.read_text())
    assert JAX_STAMP_KEYS <= set(stamp) and stamp["step"] == 7
    assert stamp["device"]["type"] == "cpu"
    assert stamp["package"] == "defensegan_torch"
    assert stamp["pass"] == int8_gate_ok(
        stamp["material_disagreement_int8"],
        stamp["material_disagreement_bf16"],
        stamp["best_loss_absdiff_p95"],
        stamp["best_loss_absdiff_p95_bf16_control"])
    assert set(out["metrics"]) == JAX_METRIC_KEYS
    assert [(r["metric"], r["batch"]) for r in out["bench"]] == \
        [("v2_bf16_batch4", 4), ("v2i_int8_batch4", 4)]
    assert all(np.isfinite(r["recon_per_sec"]) for r in out["bench"])
    assert not (pathlib.Path(run) / "checkpoints" / "int8_gate.json") \
        .exists()


def test_int8_validate_out_and_refusals(run, tmp_path):
    target = tmp_path / "gate.json"
    int8_validate.main(["--cfg", run, "--out", str(target), "--batch", "4",
                        "--bench_batches"] + TINY)
    assert json.loads(target.read_text())["step"] == 7
    with pytest.raises(SystemExit, match="no trained GAN"):
        int8_validate.main(["--cfg", run, "--output_dir",
                            str(tmp_path / "empty"), "--bench_batches"]
                           + TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        int8_validate.main(["--cfg", run, "--bench_batches"])


@pytest.fixture
def cached_classifier(tmp_path, monkeypatch):
    monkeypatch.setattr(clf_cache, "CACHE_ROOT",
                        str(tmp_path / "classifiers_torch"))
    model = build_classifier("E", gen=torch.Generator().manual_seed(0))
    clf_cache.save_classifier("mnist_modelE",
                              clf_cache.ClassifierState(model))
    return tmp_path


@pytest.mark.parametrize("extra", [
    [], ["--sharded", "--input_dtype", "uint8", "--clf_dtype", "bfloat16",
         "--detector", "combined", "--detect_passes", "2"]])
def test_serving_bench_rows(run, cached_classifier, extra):
    results = cached_classifier / "results"
    rows = serving_bench.main(
        ["--cfg", run, "--model", "E", "--batches", "1", "5", "--repeats",
         "1", "--calib_n", "16", "--results_dir", str(results)] + TINY
        + extra)
    written = [json.loads(line) for line in
               open(results / "serving_bench.jsonl")]
    assert written == rows and [r["batch"] for r in rows] == [1, 5]
    for r in rows:
        assert set(r) == JAX_ROW_KEYS | {"device", "package"}
        assert r["device"]["type"] == "cpu" and r["kernel"] == "packed"
        assert r["sharded"] == ("--sharded" in extra)
        assert r["images_per_s"] > 0 and r["rec_iters"] == 3
    if extra:
        assert rows[0]["input_dtype"] == "uint8"
        assert 0.0 <= rows[0]["clf_bf16_disagree"] <= 1.0


def test_serving_bench_needs_a_cached_classifier(run, cached_classifier):
    with pytest.raises(SystemExit, match="no cached classifier"):
        serving_bench.main(["--cfg", run, "--model", "A", "--batches", "1",
                            "--results_dir", str(cached_classifier)]
                           + TINY)
