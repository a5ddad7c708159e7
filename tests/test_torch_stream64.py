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

import ctypes
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "scripts"))
sys.path.insert(2, os.path.join(ROOT, "tests"))

import chip_smoke  # noqa: E402
import stream64_probe as jax_probe  # noqa: E402
from defensegan_torch.experiments import stream64_probe as sp  # noqa: E402
from defensegan_torch.kernels import build  # noqa: E402
from defensegan_torch.kernels.conv3x3 import _tap_magnitudes  # noqa: E402
from defensegan_torch.kernels.grid import tap_masks  # noqa: E402
from torch_csrc_signatures import c_signatures  # noqa: E402

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


@pytest.mark.parametrize("level", [0, 1, 2])
def test_zero_blocks_are_the_phase_structure(level):
    """The table the kernel skips by is the phase-major form's own: 11 of
    the 36 (tap, phase) blocks zero at every level, whatever the draws (a
    phase uses 3 x 3, 3 x 2, 2 x 3 or 2 x 2 of the 9 taps), the 64-lane
    bits those phases' lanes; and the backward's K slabs of W_k^T zero
    exactly where W_k's columns are."""
    g, ci, co = sp.LEVELS[level]
    tables = []
    for seed in (0, 5):
        pack = _pack(_arrays(level, seed), level)
        zero = pack.zero.numpy()
        bits = np.array([[(int(z) >> b) & 1 for b in range(4 * co // 64)]
                         for z in zero], bool)
        phases = bits.reshape(9, 4, -1)
        assert (phases.all(2) == phases.any(2)).all()   # whole phases
        assert phases.all(2).sum() == 11
        assert sorted((~phases.all(2)).sum(0).tolist()) == [4, 6, 6, 9]
        w = pack.w.float().reshape(9, ci, 4 * co // 64, 64)
        np.testing.assert_array_equal(bits, ~w.ne(0).any(dim=(1, 3)).numpy())
        wt = pack.wt.float().reshape(9, 4 * co // 64, 64, ci)
        np.testing.assert_array_equal(bits,
                                      ~wt.ne(0).any(dim=(2, 3)).numpy())
        tables.append(zero)
    np.testing.assert_array_equal(*tables)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_plain_level_without_the_zero_blocks_is_bit_for_bit(level):
    """Leaving out the table's blocks (the forward's taps into them, the
    backward's K slabs of them), as the kernel does, changes no bit of dh
    or dx: they added exact zeros."""
    a = _arrays(level, seed=3)
    pack = _pack(a, level)
    x = torch.from_numpy(a["x0"])
    cot = sp.to_phase_blocked(torch.from_numpy(a["cot"])).to(torch.bfloat16)
    dx, dh = sp.fused_level_plain(x, cot, pack, return_dh=True)
    dx_s, dh_s = sp.fused_level_plain(x, cot, pack, return_dh=True,
                                      skip_zero=True)
    assert torch.equal(dh, dh_s) and torch.equal(dx, dx_s)
    assert (dx != 0).float().mean() > 0.5


@pytest.mark.parametrize("level", [0, 1, 2])
def test_issued_slabs_and_walks(level):
    """What the skip leaves to issue at the pack's 128-lane forward tiles:
    27.75%, 29.29% and 23.13% fewer multiply-adds than every block at
    levels 0, 1, 2 (the border taps, already skipped, hold more of the
    zero blocks on the smaller grids; at level 2 a 128-lane tile spans two
    phases and skips 3 of its 18 (tap, n-tile) pairs, 64-lane tiles all 11
    zero blocks: 29.95%); each walk ranks the pixels by their issued
    slabs, most first."""
    g, ci, co = sp.LEVELS[level]
    pack = _pack(_arrays(level), level)
    zero = pack.zero.numpy()
    assert pack.bn == 128
    total = {}
    for skip in (True, False):
        z = zero if skip else None
        fwd = sp.tile_slabs(z, g, ci, 4 * co, pack.bn, False)
        bwd = sp.tile_slabs(z, g, ci, 4 * co, pack.bn, True)
        assert fwd.shape == (g * g, 4 * co // 128)
        assert bwd.shape == (g * g, ci // 128)
        total[skip] = fwd.sum() * pack.bn + bwd.sum() * 128
        if skip:
            np.testing.assert_array_equal(
                pack.order.numpy(), np.argsort(-fwd.sum(1), kind="stable"))
            np.testing.assert_array_equal(
                pack.order_t.numpy(), np.argsort(-bwd.sum(1), kind="stable"))
            assert (np.diff(fwd.sum(1)[pack.order.numpy()]) <= 0).all()
    assert round(1.0 - total[True] / total[False], 4) == \
        {0: 0.2775, 1: 0.2929, 2: 0.2313}[level]
    # every block: the 9-tap count times every slab
    all_fwd = sp.issued_slabs(None, g, ci, 4 * co, 128, False)
    np.testing.assert_array_equal(
        all_fwd, tap_masks(g).sum(1) * (4 * co // 128) * (ci // 64))
    if level == 2:
        narrow = sp.issued_slabs(zero, g, ci, 4 * co, 64, False).sum()
        wide = sp.issued_slabs(zero, g, ci, 4 * co, 128, False).sum()
        every = sp.issued_slabs(None, g, ci, 4 * co, 128, False).sum()
        assert round(1.0 - narrow * 64 / (every * 128), 4) == 0.2995
        assert round(1.0 - wide / every, 4) == 0.163


def test_level_binding_matches_the_c_signature():
    restype, params = c_signatures("stream64_level.cu")["fp_stream64_level"]
    assert restype is ctypes.c_int and params == sp.LEVEL_ARGTYPES


def test_skip_needs_the_card_for_the_kernel_and_keeps_the_cpu_plain():
    """On CPU tensors fused_level runs the plain version either way and
    counts no launch; skip=False and skip=True agree bit for bit."""
    a = _arrays(1, seed=4)
    pack = _pack(a, 1)
    x = torch.from_numpy(a["x0"])
    cot = sp.to_phase_blocked(torch.from_numpy(a["cot"])).to(torch.bfloat16)
    before = build.LAUNCHES[sp.COUNTER]
    assert torch.equal(sp.fused_level(x, cot, pack),
                       sp.fused_level(x, cot, pack, skip=False))
    assert build.LAUNCHES[sp.COUNTER] == before
