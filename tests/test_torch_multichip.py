"""The port's multi-device dry run (multichip_torch.py::dryrun_multichip)
on gloo ranks on the CPU: every check of the JAX package's
__graft_entry__.py::dryrun_multichip and its two-process rehearsal
(scripts/multihost_smoke.py), run once on two ranks."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from multichip_torch import dryrun_multichip, main  # noqa: E402


@pytest.fixture(scope="module")
def line():
    return dryrun_multichip(2, device="cpu")


def test_dryrun_two_ranks_completes(line):
    assert line["ok"] and line["n"] == 2 and line["backend"] == "gloo"
    assert line["pipeline_path"] == "xla"
    assert line["tp_err"] is not None and line["tp_err"] <= 5e-6
    assert set(line["sharded_err"]) == {"random", "encoder"}
    # the sharded serving's per-shard runs are exact on the CPU
    assert line["sharded_err"] == {"random": 0.0, "encoder": 0.0}


def test_cli_without_a_card_refuses(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(1)
