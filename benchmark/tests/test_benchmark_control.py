"""The check's control: the plain reference in the program's place, one
precision step below the configuration's bfloat16 (every product's
operands in fp8 e4m3), comes out not correct, where the program comes out
correct on the same seed. On the CPU at a tiny size; on the card at the
cell's own size (`-m cuda`)."""

import pytest
import torch

import bench_tiny
from benchmark import control, spec
from bench_tiny import BENCH


@pytest.mark.parametrize("config", ["mnist_fast", "mnist"])
def test_fp8_control_is_not_correct_tiny(config, monkeypatch):
    cell = next(w for w in BENCH["workloads"] if w["config"] == config)
    bench_tiny.tiny(config, 8, monkeypatch)
    dev = torch.device("cpu")
    sound = control.readings(BENCH, cell, 2 ** 31 + 3, "program", 0.05, dev)
    ctrl = control.readings(BENCH, cell, 2 ** 31 + 3, "fp8", 0.05, dev)
    assert sound["correct"] and not ctrl["correct"], (sound, ctrl)
    for name in ("xhat_gap_max", "margin_gap_max"):
        assert ctrl["numbers"][name] > 3 * sound["numbers"][name]


@pytest.mark.parametrize("config", ["mnist_fast", "mnist"])
def test_frozen_restarts_fault_is_not_correct_tiny(config, monkeypatch):
    """Half of every image's restarts left at their draws: the 25th
    percentile of the restart gaps does not see it, the far share does."""
    cell = next(w for w in BENCH["workloads"] if w["config"] == config)
    bench_tiny.tiny(config, 8, monkeypatch)
    out = control.readings(BENCH, cell, 2 ** 31 + 3, "frozen", 0.05,
                           torch.device("cpu"))
    assert not out["correct"], out
    assert out["numbers"]["restart_far_pct"] >= 40.0, out["numbers"]


@pytest.mark.parametrize("mode", ["fp8", "frozen"])
def test_controls_under_encoder_init_tiny(mode, monkeypatch):
    """Under encoder init the reference in the program's place starts
    restart 0 at its own E(x), in fp8 for the fp8 control and in float32
    for the frozen fault: both not correct, where the program (with the
    stand-in for its encoder start) is correct on the same seed."""
    from benchmark import check
    cell = spec.cell(BENCH, "mnist_fast.bulk10k")
    bench_tiny.tiny_encoder(8, monkeypatch)
    bench_tiny.encoder_stand_in(monkeypatch)
    precs = []
    real = check.encoder_starts

    def starts(*a, prec=control.FP32, **kw):
        precs.append(prec)
        return real(*a, prec=prec, **kw)

    monkeypatch.setattr(check, "encoder_starts", starts)
    dev = torch.device("cpu")
    sound = control.readings(BENCH, cell, 2 ** 31 + 3, "program", 0.05, dev)
    assert sound["correct"], sound
    precs.clear()
    out = control.readings(BENCH, cell, 2 ** 31 + 3, mode, 0.05, dev)
    assert not out["correct"], out
    # the program's place (calibration and requests) at the mode's
    # precision, then the check's own float32 starts
    want = control.FP8 if mode == "fp8" else control.FP32
    assert precs[:-2] and set(precs[:-2]) == {want}
    assert precs[-2:] == [control.FP32, control.FP32]
    if mode == "frozen":
        assert out["numbers"]["restart_far_pct"] >= 40.0, out["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]
                                  if w["traffic"] == "bulk10k"])
def test_fp8_control_is_not_correct_on_the_card(cell, cuda_device):
    c = spec.cell(BENCH, cell)
    sound = control.readings(BENCH, c, 2 ** 31 + 11, "program", 0.1,
                             cuda_device)
    ctrl = control.readings(BENCH, c, 2 ** 31 + 11, "fp8", 0.1,
                            cuda_device)
    assert sound["correct"] and not ctrl["correct"], (sound, ctrl)
