"""PyTorch port vs JAX: the stream64 probe, one fused deconv level
(defensegan_torch/experiments/stream64_probe.py).

On the CPU the level's wrapper runs its plain version, held here against
the JAX probe's Pallas kernel in interpret mode (scripts/stream64_probe.py,
imported from scripts/ as tests/test_stream64_probe.py does) at that test's
sizes, batch 4, tile 2: the same numpy weights, x and cotangent. Both
round at the same points (x and the weights bf16, h float32 until the relu
test, dh bf16, each backward tap bf16) and differ in float32 summation
order only. So dx agrees to 1e-5 of its largest element except where the
two orders put a backward tap's float32 sum on the two sides of a bf16
rounding boundary: that element then moves by one bf16 ulp of the tap
(measured: 8 or 9 elements of 32768 to 131072, up to 4.3e-4 of the
largest). The bound is therefore 1e-5 of the largest element plus one
bf16 ulp (2^-7) of every rounded tap's size, and at most one element in a
thousand may pass the 1e-5 alone; a misplaced tap or phase moves every
element by tens of percent. The CUDA kernel is held against
the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "scripts"))

import chip_smoke  # noqa: E402
import stream64_probe as jax_probe  # noqa: E402
from defensegan_torch.experiments import stream64_probe as sp  # noqa: E402
from defensegan_torch.kernels import build  # noqa: E402
from defensegan_torch.kernels.conv3x3 import _tap_magnitudes  # noqa: E402

torch.set_num_threads(2)

BATCH, TILE = 4, 2


def _arrays(level, seed=0):
    """The probe's draws, in numpy (as the JAX probe draws them)."""
    g, ci, co = sp.LEVELS[level]
    rng = np.random.RandomState(seed)
    return dict(w=(0.1 * rng.randn(5, 5, ci, co)).astype(np.float32),
                b=(0.1 * rng.randn(co)).astype(np.float32),
                scale=(1.0 + 0.1 * rng.randn(co)).astype(np.float32),
                shift=(0.05 * rng.randn(co)).astype(np.float32),
                x0=rng.randn(BATCH, g, g, ci).astype(np.float32),
                cot=rng.randn(BATCH, 2 * g, 2 * g, co).astype(np.float32))


def _pack(a, level):
    g = sp.LEVELS[level][0]
    return sp.level_tensors(*sp.pack_level(a["w"], a["b"], a["scale"],
                                           a["shift"]), g, "cpu")


@pytest.mark.parametrize("level", [0, 1, 2])
def test_pack_level_equals_jax(level):
    a = _arrays(level)
    got = sp.pack_level(a["w"], a["b"], a["scale"], a["shift"])
    ref = jax_probe.pack_level(a["w"], a["b"], a["scale"], a["shift"])
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_layouts_equal_jax(level):
    """phase_perm, to_rows, from_rows as the JAX probe's, and the
    phase-blocked cotangent equal to its scatter through phase_perm."""
    g, _, co = sp.LEVELS[level]
    np.testing.assert_array_equal(sp.phase_perm(g, co),
                                  jax_probe.phase_perm(g, co))
    a = _arrays(level)
    rows = sp.to_rows(torch.from_numpy(a["x0"]), TILE)
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(jax_probe.to_rows(jnp.asarray(a["x0"]),
                                                   TILE)))
    np.testing.assert_array_equal(
        sp.from_rows(rows, BATCH, g, TILE).numpy(), a["x0"])
    idx = jax_probe.phase_perm(g, co)
    blk = np.zeros((BATCH, g, g, 4 * co), np.float32)
    blk[:, idx[..., 0], idx[..., 1], idx[..., 2]] = a["cot"]
    np.testing.assert_array_equal(
        sp.to_phase_blocked(torch.from_numpy(a["cot"])).numpy(), blk)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_plain_level_matches_pallas_interpret(level):
    g, _, co = sp.LEVELS[level]
    a = _arrays(level)
    wcat, wcat_t, bias = jax_probe.pack_level(a["w"], a["b"], a["scale"],
                                              a["shift"])
    cot_blk = sp.to_phase_blocked(torch.from_numpy(a["cot"]))
    fused = jax_probe.make_fused_level(wcat, wcat_t, bias, g, TILE,
                                       interpret=True)
    dx_rows = fused(jnp.asarray(sp.to_rows(a["x0"], TILE), jnp.bfloat16),
                    jnp.asarray(sp.to_rows(cot_blk.numpy(), TILE),
                                jnp.bfloat16))
    ref = sp.from_rows(np.asarray(dx_rows), BATCH, g, TILE)
    before = build.LAUNCHES[sp.COUNTER]
    pack = _pack(a, level)
    got, dh = sp.fused_level(torch.from_numpy(a["x0"]),
                             cot_blk.to(torch.bfloat16), pack,
                             return_dh=True)
    # the CPU path is the plain version: no kernel launch is counted
    assert build.LAUNCHES[sp.COUNTER] == before
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err = np.abs(got.numpy() - ref)
    tight = 1e-5 * np.abs(ref).max()
    taps = _tap_magnitudes(dh.float(), pack.wt.float().reshape(
        9, 4 * co, pack.ci), g).numpy()
    assert (err <= tight + 2.0 ** -7 * taps).all()
    assert (err > tight).mean() <= 1e-3, int((err > tight).sum())


@pytest.mark.parametrize("level", [0, 1, 2])
def test_run_probe_numerics_gate_passes(level):
    r = sp.run_probe(level, BATCH, TILE, iters=1, repeats=1, device="cpu",
                     arrays=_arrays(level, seed=1))
    assert r["numerics_ok"], r
    assert r["device"] == "cpu" and r["speedup"] > 0
    assert r["bound_by"] in ("bytes", "operations")


@pytest.mark.parametrize("level", [0, 1, 2])
def test_level_macs_equal_deconv_macs(level):
    g, ci, co = sp.LEVELS[level]
    assert sp.level_macs(level) == chip_smoke.deconv_macs(g, ci, co)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_check_against_plain_holds_the_plain_version(level):
    """The card's check passes the plain version against itself and
    catches a dx off by one tap."""
    a = _arrays(level)
    pack = _pack(a, level)
    x = torch.from_numpy(a["x0"])
    cot = sp.to_phase_blocked(torch.from_numpy(a["cot"])).to(torch.bfloat16)
    dx, dh = sp.fused_level(x, cot, pack, return_dh=True)
    r = sp.check_against_plain(x, cot, pack, dx, dh)
    assert r["ok"] and r["relu_flips"] == 0 and r["max_abs_err"] == 0.0, r
    wrong = dx.clone()
    wrong[:, 1:] += dx[:, :-1] * 0.5          # a neighbour's rows leak in
    assert not sp.check_against_plain(x, cot, pack, wrong, dh)["ok"]


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert sp.resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sp.run_probe(0, BATCH, TILE, 1, 1)
    assert sp.resolve_device("cpu").type == "cpu"


def test_decision_rule():
    assert sp.decision([1.5, 1.4, 1.36])["verdict"] == \
        "build the full kernel"
    assert sp.decision([1.0, 1.1, 1.2])["verdict"] == "close the question"
    assert sp.decision([1.2, 1.3, 1.25])["verdict"] == "undecided"


def test_script_runs_on_the_cpu(tmp_path):
    rows = sp.main(["--device", "cpu", "--levels", "2", "--batch", "4",
                    "--tile", "2", "--iters", "1", "--repeats", "1",
                    "--results_dir", str(tmp_path)])
    assert len(rows) == 1 and rows[0]["numerics_ok"]
    assert (tmp_path / "stream64_probe.jsonl").exists()


@pytest.mark.parametrize("level", [0, 2])
def test_check_against_library_catches_a_wrong_dx(level):
    """The probe's numerics check passes the plain version (within 2.3e-3
    of the library on these draws, as the JAX probe's kernel was of XLA's
    on the TPU) and fails a dx with a neighbour's rows leaked in."""
    a = _arrays(level, seed=2)
    pack = _pack(a, level)
    x, cot = torch.from_numpy(a["x0"]), torch.from_numpy(a["cot"])
    dx, dh = sp.fused_level(x, sp.to_phase_blocked(cot).to(torch.bfloat16),
                            pack, return_dh=True)
    args = (a["w"], a["b"], a["scale"], a["shift"], x, cot)
    r = sp.check_against_library(*args, dx, dh)
    assert r["numerics_ok"] and r["rel_err"] < 5e-3, r
    wrong = dx.clone()
    wrong[:, 1:] += dx[:, :-1] * 0.5
    assert not sp.check_against_library(*args, wrong, dh)["numerics_ok"]
    np.testing.assert_array_equal(
        sp.from_phase_blocked(sp.to_phase_blocked(cot)).numpy(), a["cot"])
