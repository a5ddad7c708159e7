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

import ctypes
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
from torch_csrc_signatures import (  # noqa: E402
    c_signatures, c_struct_fields)

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


def test_call_table_covers_every_case():
    """One ctypes call a case: CALLS has exactly the cases, each naming an
    extern "C" entry of csrc/v3_diag.cu, with a pointer for every input,
    the output and each scratch buffer, then its DiagDims' address, then
    the stream; the dims fill DiagDims."""
    assert list(v3_diag.CALLS) == list(v3_diag.CASES)
    entries = c_signatures("v3_diag.cu")
    for name, call in v3_diag.CALLS.items():
        assert call.entry in entries, name
        n_ptr = len(v3_diag.CASES[name].inputs) + 1 + call.scratch
        assert call.argtypes == (ctypes.c_void_p,) * (n_ptr + 2), name
        assert len(call.dims) == len(v3_diag.DiagDims._fields_)
        v3_diag.DiagDims(*call.dims)
    for entry in v3_diag.HELPERS:
        assert entry in entries


def test_dims_struct_matches_the_c_struct():
    """v3_diag.DiagDims has csrc/v3_diag.cu's DiagDims fields, in order
    and type."""
    fields = c_struct_fields("v3_diag.cu", "DiagDims")
    assert fields == [(n, t) for n, t in v3_diag.DiagDims._fields_]


@pytest.mark.parametrize("entry", sorted(
    {c.entry for c in v3_diag.CALLS.values()} | set(v3_diag.HELPERS)))
def test_call_types_match_the_c_signature(entry):
    """The ctypes types bound for an entry are its parameters' in the
    source's text: count and type (pointer, int, long long, float), and
    every case that shares the entry binds the same types."""
    restype, params = c_signatures("v3_diag.cu")[entry]
    assert restype is ctypes.c_int
    bound = {c.argtypes for c in v3_diag.CALLS.values() if c.entry == entry}
    if entry in v3_diag.HELPERS:
        bound.add(v3_diag.HELPERS[entry])
    assert bound == {tuple(params)}


@pytest.mark.parametrize("how", ["shape", "dtype", "device", "count",
                                 "strides"])
def test_validation_raises_before_any_launch(how):
    """The wrapper's cheap checks still refuse what its kernel does not
    take: another shape, type or device (the CPU beside a meta tensor, or
    a device that is neither the CPU nor a card), a missing input, a
    non-contiguous input; nothing is launched or counted."""
    a, m = v3_diag.draw_inputs("mask-lane-slice")
    bad = {"shape": (a[:, :64].contiguous(), m),
           "dtype": (a, m.double()),
           "device": (a, m.to("meta")),
           "count": (a,),
           "strides": (a.t().contiguous().t(), m)}[how]
    before = build.LAUNCHES[v3_diag.COUNTER]
    with pytest.raises(ValueError):
        v3_diag.diag_case("mask-lane-slice", *bad)
    meta = [t.to("meta") for t in (a, m)]
    with pytest.raises(ValueError, match="neither the CPU nor a card"):
        v3_diag.diag_case("mask-lane-slice", *meta)
    assert build.LAUNCHES[v3_diag.COUNTER] == before


@pytest.mark.parametrize("name", list(v3_diag.CASES))
def test_out_is_written_and_equals_the_allocating_call(name):
    """diag_case_into(out, ...) and diag_case_library(..., out=) write the
    case into the given output and return it, bit for bit what the
    allocating calls (diag_case, diag_case_library) return."""
    inputs = v3_diag.draw_inputs(name)
    shape, dtype = v3_diag.CASES[name].out
    into = {v3_diag.diag_case: lambda out: v3_diag.diag_case_into(
                out, name, *inputs),
            v3_diag.diag_case_library: lambda out: v3_diag.diag_case_library(
                name, *inputs, out=out)}
    for fn, fn_into in into.items():
        ref = fn(name, *inputs)
        out = torch.full(shape, float("nan"), dtype=dtype)
        got = fn_into(out)
        assert got is out and torch.equal(out, ref), fn.__name__


@pytest.mark.parametrize("how", ["shape", "dtype", "strides", "device",
                                 "overlap"])
def test_out_is_checked_before_any_launch(how):
    """A given output of another shape, type or device, not contiguous,
    or overlapping an input, raises; nothing is launched or counted."""
    a, m = v3_diag.draw_inputs("mask-lane-slice")
    out = {"shape": torch.empty(a.shape[0], 64),
           "dtype": torch.empty(a.shape, dtype=torch.float64),
           "strides": torch.empty(a.shape[::-1]).t(),
           "device": torch.empty(a.shape, device="meta"),
           "overlap": a}[how]
    before = build.LAUNCHES[v3_diag.COUNTER]
    with pytest.raises(ValueError, match="out"):
        v3_diag.diag_case_into(out, "mask-lane-slice", a, m)
    assert build.LAUNCHES[v3_diag.COUNTER] == before


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
