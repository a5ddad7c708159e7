"""PyTorch port vs JAX: the ten construct probes of the v3 kernel
(defensegan_torch/experiments/v3_diag.py against scripts/pallas_v3_diag.py).

The JAX script's cases are closures inside its main(): its `run_case` is
replaced by one that records them, then each runs as a Pallas kernel in
interpret mode at the script's own shapes (ROWS 6272, C0 128, CA 256, CB
16) on the script's inputs. On the CPU the port's wrapper runs its plain
version. Bounds: the copies, the mask product and the sum of two bf16
values bit for bit; the single products and the tanh chain within 1e-6 of
the output's largest magnitude (measured: 2e-7, float32 summation order
and tanh); the two chains of four products, which round to bf16 between
products, within 1e-2 of it (measured: 1.75e-3, a rounding that a sum near
its boundary takes the other way, carried through the later products).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "scripts"))

import pallas_v3_diag as jax_diag  # noqa: E402
from defensegan_torch.experiments import v3_diag  # noqa: E402
from defensegan_torch.kernels import build  # noqa: E402

TOL = {"product": 1e-6, "tanh": 1e-6, "chain": 1e-2}


@pytest.fixture(scope="module")
def jax_cases():
    """{case: (kernel, in_shapes, out_shape)} as the script's main() hands
    them to run_case, in its order."""
    cases = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_diag, "run_case",
                   lambda name, kernel, ins, out: cases.update(
                       {name: (kernel, ins, out)}))
        jax_diag.main()
    return cases


def _jax_inputs(ins):
    """The script's draws: input i is RandomState(i).randn in its type."""
    return [np.random.RandomState(i).randn(*s[0]).astype(s[1])
            for i, s in enumerate(ins)]


def _jax_run(case):
    kernel, ins, out = case
    f = pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM) for _ in ins],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(*out), interpret=True)
    return np.asarray(f(*[jnp.asarray(a) for a in _jax_inputs(ins)]))


def test_cases_are_the_scripts(jax_cases):
    assert list(jax_cases) == list(v3_diag.CASES)
    for name, (_, ins, out) in jax_cases.items():
        case = v3_diag.CASES[name]
        assert [tuple(s) for s, _ in ins] == [s for s, _ in case.inputs]
        assert [jnp.dtype(d).name for _, d in ins] == \
            [str(d).split(".")[1] for _, d in case.inputs]
        assert tuple(out[0]) == case.out[0]
        assert jnp.dtype(out[1]).name == str(case.out[1]).split(".")[1]


@pytest.mark.parametrize("name", list(v3_diag.CASES))
def test_plain_case_matches_pallas_interpret(jax_cases, name):
    ins = jax_cases[name][1]
    inputs = v3_diag.draw_inputs(name)
    for t, a in zip(inputs, _jax_inputs(ins)):      # the same draws
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32))
    before = build.LAUNCHES[v3_diag.COUNTER]
    got = v3_diag.diag_case(name, *inputs)
    assert build.LAUNCHES[v3_diag.COUNTER] == before   # the plain version
    ref = _jax_run(jax_cases[name]).astype(np.float32)
    got = got.float().numpy()
    kind = v3_diag.CASES[name].kind
    if kind == "copy":
        np.testing.assert_array_equal(got, ref)
    else:
        scale = np.abs(ref).max()
        assert scale > 0
        assert np.abs(got - ref).max() <= TOL[kind] * scale, \
            (np.abs(got - ref).max() / scale)


def test_moves_read_the_scripts_rows():
    """roll reads row r - s and wraps (np.roll); shift reads row r + s and
    fills with zeros, in both directions."""
    v = torch.arange(10.0)[:, None]
    np.testing.assert_array_equal(v3_diag.roll_rows(v, 3).numpy(),
                                  np.roll(v.numpy(), 3, axis=0))
    np.testing.assert_array_equal(v3_diag.shift_rows(v, 3)[:, 0].numpy(),
                                  [3, 4, 5, 6, 7, 8, 9, 0, 0, 0])
    np.testing.assert_array_equal(v3_diag.shift_rows(v, -2)[:, 0].numpy(),
                                  [0, 0, 0, 1, 2, 3, 4, 5, 6, 7])


@pytest.mark.parametrize("name", list(v3_diag.CASES))
def test_check_holds_the_plain_version_and_catches_a_moved_row(name):
    inputs = v3_diag.draw_inputs(name)
    ref = v3_diag.diag_case_plain(name, *inputs)
    assert v3_diag.check(name, ref.clone(), ref, inputs)["ok"]
    bad = torch.roll(ref, 1, dims=0)                 # one row off
    assert not v3_diag.check(name, bad, ref, inputs)["ok"]


def test_case_bounds_count_bytes_and_products():
    b = v3_diag.case_bound("matmul")
    assert b["flop"] == 2 * 6272 * 128 * 256
    assert b["bytes"] == 6272 * 128 * 2 + 128 * 256 * 2 + 6272 * 256 * 4
    assert b["bound_by"] == "bytes"
    chain = v3_diag.case_bound("fori-shift-matmul")
    assert chain["flop"] == 4 * 2 * 6272 * 128 * 128
    assert v3_diag.case_bound("roll-bf16")["flop"] == 0


def test_wrapper_rejects_inputs_of_another_shape_or_type():
    a, b = v3_diag.draw_inputs("matmul")
    with pytest.raises(ValueError, match="contiguous"):
        v3_diag.diag_case("matmul", a[:100], b)
    with pytest.raises(ValueError, match="contiguous"):
        v3_diag.diag_case("matmul", a.float(), b)
    with pytest.raises(ValueError, match="no case"):
        v3_diag.diag_case("no-such-case", a, b)


def test_script_runs_every_case_on_the_cpu():
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "pallas_v3_diag_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    passed = [ln for ln in r.stdout.splitlines() if ln.startswith("PASS ")]
    assert [ln.split(":")[0][5:] for ln in passed] == list(v3_diag.CASES)


def test_script_exits_nonzero_when_a_case_fails(monkeypatch, capsys):
    real = v3_diag.diag_case

    def broken(name, *inputs):
        if name == "roll-bf16":
            raise RuntimeError("launch refused")
        return real(name, *inputs)

    monkeypatch.setattr(v3_diag, "diag_case", broken)
    with pytest.raises(SystemExit) as e:
        v3_diag.main(["--device", "cpu"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "FAIL roll-bf16: RuntimeError: launch refused" in out
    assert out.count("PASS ") == 9
