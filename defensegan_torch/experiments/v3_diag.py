"""The ten construct probes of the v3 kernel, at its shapes.

Port of scripts/pallas_v3_diag.py, the JAX package's bisection of which
construct of kernels/fused_projection_v3.py crashed the Mosaic compiler:
ten micro-kernels, each one construct at v3's shapes (ROWS = 49 * 128,
C0 128, CA 256, CB 16), run once and summed (`PASS <case>: sum=...`). With
roll(v, s)[r] = v[(r - s) mod R] (pltpu.roll and np.roll) and shift(v,
s)[r] = v[r + s] where r + s lies in [0, R), else 0 (the script's
shift_rows), the cases are:

    matmul                a[R, C0] @ b[C0, CA]                        f32
    concat-sublanes-49    out[p*T + t] = (z @ w[:, p*C0:(p+1)*C0])[t]  f32
    roll-bf16             f32(roll(a, 5376))                          f32
    mask-lane-slice       a * m[:, 3:4]                               f32
    concat-lanes-9x16     [roll(a, 128k) for k < 9] on lanes          bf16
    narrow-elementwise    (tanh a - b)(1 - tanh^2 a) * 2/784          f32
    fori-roll-matmul      4 x acc = bf16(roll(acc, 128)) @ b          f32
    shift-slice-concat    f32(shift(a, 1024)) + f32(shift(a, -768))   f32
    concat-lanes-norolls  9 copies of a on lanes                      bf16
    fori-shift-matmul     4 x acc = bf16(shift(acc, 128)) @ b         f32

(the roll reads row r - 128 and wraps; the shift reads row r + 128 and
fills with zeros). Input i of a case is np.random.RandomState(i).randn,
cast once from float64 to its type, as the script draws it.

`diag_case` runs a case: on CUDA tensors through its hand-written kernel
(csrc/v3_diag.cu: the four products on the port's wgmma GEMM with the row
moves in their stores, the rest one elementwise pass each), on CPU
tensors through `diag_case_plain`. `check` holds a result against the
plain version (the bounds below), `run_cases` is the script's run (scripts/
pallas_v3_diag_torch.py): every case once, checked, timed.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from defensegan_torch.kernels import build
from defensegan_torch.kernels.gemm import rounding_excess

T = 128
G = 7
P2 = G * G
ROWS = P2 * T
C0 = 128
CA = 256
CB = 16
LIBRARY = COUNTER = "v3_diag"     # the library and its build.LAUNCHES key
ROLL_SHIFT = (ROWS - 7 * T) % ROWS          # roll-bf16
MASK_COL = 3                                # mask-lane-slice
LANES = 9                                   # the lane concats' copies
TANH_SCALE = 2.0 / 784                      # narrow-elementwise
CHAIN_STEPS = 4                             # the two fori loops
SHIFTS = (8 * T, -6 * T)                    # shift-slice-concat
# bounds of a kernel against its plain version (and of the plain version
# against the Pallas kernel in interpret mode): a copy, the mask product
# and the sum of two bf16 values are exact on both sides; a product sums
# in another order (gemm.rounding_excess: 1e-4 of the summed absolute
# products); tanhf and torch.tanh differ by an ulp or two of t, so k6 is
# held within 8 float32 ulps of the size of its terms, 2^-23 * 8 *
# (1 + |b|) * 2/784; the chains round to bf16 between products, where a
# sum that lands near a rounding boundary takes the other side (1.75e-3 of
# the output's largest magnitude between the plain version and the Pallas
# kernel in interpret mode), so they are held within 1e-2 of it.
CHAIN_TOL = 1e-2
ULPS_K6 = 8


class Case(NamedTuple):
    inputs: tuple         # ((shape, dtype), ...) in argument order
    out: tuple            # (shape, dtype)
    kind: str             # how `check` holds it: copy, product, tanh, chain


_bf, _f32 = torch.bfloat16, torch.float32
CASES = {
    "matmul": Case((((ROWS, C0), _bf), ((C0, CA), _bf)),
                   ((ROWS, CA), _f32), "product"),
    "concat-sublanes-49": Case((((T, C0), _bf), ((C0, P2 * C0), _bf)),
                               ((ROWS, C0), _f32), "product"),
    "roll-bf16": Case((((ROWS, C0), _bf),), ((ROWS, C0), _f32), "copy"),
    "mask-lane-slice": Case((((ROWS, C0), _f32), ((ROWS, 9), _f32)),
                            ((ROWS, C0), _f32), "copy"),
    "concat-lanes-9x16": Case((((ROWS, CB), _bf),), ((ROWS, LANES * CB), _bf),
                              "copy"),
    "narrow-elementwise": Case((((ROWS, CB), _f32), ((ROWS, CB), _bf)),
                               ((ROWS, CB), _f32), "tanh"),
    "fori-roll-matmul": Case((((ROWS, C0), _f32), ((C0, C0), _bf)),
                             ((ROWS, C0), _f32), "chain"),
    "shift-slice-concat": Case((((ROWS, C0), _bf),), ((ROWS, C0), _f32),
                               "copy"),
    "concat-lanes-norolls": Case((((ROWS, CB), _bf),),
                                 ((ROWS, LANES * CB), _bf), "copy"),
    "fori-shift-matmul": Case((((ROWS, C0), _f32), ((C0, C0), _bf)),
                              ((ROWS, C0), _f32), "chain"),
}


def draw_inputs(name: str, device="cpu") -> list:
    """The case's inputs as the script draws them: input i is
    RandomState(i).randn, cast once from float64 to its type."""
    return [torch.from_numpy(np.random.RandomState(i).randn(*shape))
            .to(dtype).to(device)
            for i, (shape, dtype) in enumerate(CASES[name].inputs)]


def roll_rows(v: torch.Tensor, s: int) -> torch.Tensor:
    """roll(v, s)[r] = v[(r - s) mod R]."""
    return torch.roll(v, s, dims=0)


def shift_rows(v: torch.Tensor, s: int) -> torch.Tensor:
    """shift(v, s)[r] = v[r + s] where 0 <= r + s < R, else 0."""
    out = torch.zeros_like(v)
    n = v.shape[0]
    if s >= 0:
        out[:n - s] = v[s:]
    else:
        out[-s:] = v[:n + s]
    return out


def _mm_f32(a, b):
    """bf16 operands multiplied in float32 (on a card TF32 is off)."""
    return a.float() @ b.float()


def _mm_library(a, b):
    """One cuBLAS bf16 product, its output rounded to bf16 as the library
    returns it (the yardstick only)."""
    return torch.matmul(a, b).float()


def _compose(name: str, inputs, mm: Callable) -> torch.Tensor:
    if name == "matmul":
        return mm(*inputs)
    if name == "concat-sublanes-49":
        z, w = inputs
        return torch.cat([mm(z, w[:, p * C0:(p + 1) * C0])
                          for p in range(w.shape[1] // C0)])
    if name == "roll-bf16":
        return roll_rows(inputs[0], ROLL_SHIFT).float()
    if name == "mask-lane-slice":
        a, m = inputs
        return a * m[:, MASK_COL:MASK_COL + 1]
    if name == "concat-lanes-9x16":
        a = inputs[0]
        return torch.cat([roll_rows(a, k * T % a.shape[0])
                          for k in range(LANES)], dim=1)
    if name == "narrow-elementwise":
        a, b = inputs
        t = torch.tanh(a.float())
        return (t - b.float()) * (1.0 - t * t) * TANH_SCALE
    if name in ("fori-roll-matmul", "fori-shift-matmul"):
        move = roll_rows if name == "fori-roll-matmul" else shift_rows
        a, b = inputs
        acc = a.float()
        for _ in range(CHAIN_STEPS):
            acc = mm(move(acc.to(torch.bfloat16), T), b)
        return acc
    if name == "shift-slice-concat":
        a = inputs[0]
        return shift_rows(a, SHIFTS[0]).float() + \
            shift_rows(a, SHIFTS[1]).float()
    if name == "concat-lanes-norolls":
        return torch.cat([inputs[0]] * LANES, dim=1)
    raise ValueError(f"no case {name!r}: one of {sorted(CASES)}")


def diag_case_plain(name: str, *inputs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of case `name` (products in float32)."""
    return _compose(name, inputs, _mm_f32)


def diag_case_library(name: str, *inputs: torch.Tensor) -> torch.Tensor:
    """The case composed of PyTorch's own calls, its products on cuBLAS in
    bf16: the yardstick, never called by the port."""
    return _compose(name, inputs, _mm_library)


def _check_inputs(name: str, inputs) -> torch.device:
    case = CASES.get(name)
    if case is None:
        raise ValueError(f"no case {name!r}: one of {sorted(CASES)}")
    if len(inputs) != len(case.inputs):
        raise ValueError(f"{name} takes {len(case.inputs)} inputs")
    dev = inputs[0].device
    for t, (shape, dtype) in zip(inputs, case.inputs):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name}: every input a contiguous {shape} "
                             f"{dtype} on {dev}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    return dev


def diag_case(name: str, *inputs: torch.Tensor) -> torch.Tensor:
    """Case `name` on its inputs (draw_inputs' shapes and types): the
    kernel on CUDA tensors (or raise), the plain version on CPU tensors."""
    dev = _check_inputs(name, inputs)
    if dev.type == "cpu":
        return diag_case_plain(name, *inputs)
    shape, dtype = CASES[name].out
    out = torch.empty(shape, dtype=dtype, device=dev)
    p = [t.data_ptr() for t in inputs]
    lib = build.load(LIBRARY)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if name in ("matmul", "concat-sublanes-49"):
            (m, k), n = inputs[0].shape, inputs[1].shape[1]
            fn, args = lib.fp_diag_matmul, [
                (vp, p[0]), (vp, p[1]), (vp, out.data_ptr()), (i32, m),
                (i32, n), (i32, k), (i32, C0 if name != "matmul" else 0)]
        elif name == "roll-bf16":
            fn, args = lib.fp_diag_roll_f32, [
                (vp, p[0]), (vp, out.data_ptr()), (i32, shape[0]),
                (i32, shape[1]), (i32, ROLL_SHIFT)]
        elif name == "mask-lane-slice":
            fn, args = lib.fp_diag_mask_col, [
                (vp, p[0]), (vp, p[1]), (vp, out.data_ptr()), (i32, shape[0]),
                (i32, shape[1]), (i32, inputs[1].shape[1]), (i32, MASK_COL)]
        elif name in ("concat-lanes-9x16", "concat-lanes-norolls"):
            fn, args = lib.fp_diag_lane_concat, [
                (vp, p[0]), (vp, out.data_ptr()), (i32, shape[0]),
                (i32, inputs[0].shape[1]), (i32, LANES),
                (i32, T if name == "concat-lanes-9x16" else 0)]
        elif name == "narrow-elementwise":
            fn, args = lib.fp_diag_tanh_grad, [
                (vp, p[0]), (vp, p[1]), (vp, out.data_ptr()),
                (ctypes.c_longlong, out.numel()),
                (ctypes.c_float, TANH_SCALE)]
        elif name == "shift-slice-concat":
            fn, args = lib.fp_diag_shift_sum, [
                (vp, p[0]), (vp, out.data_ptr()), (i32, shape[0]),
                (i32, shape[1]), (i32, SHIFTS[0]), (i32, SHIFTS[1])]
        else:                                   # the two fori loops
            s0, s1 = (torch.empty(shape, dtype=_bf, device=dev)
                      for _ in range(2))
            fn, args = lib.fp_diag_chain, [
                (vp, p[0]), (vp, p[1]), (vp, out.data_ptr()),
                (vp, s0.data_ptr()), (vp, s1.data_ptr()), (i32, shape[0]),
                (i32, shape[1]), (i32, CHAIN_STEPS), (i32, T),
                (i32, int(name == "fori-roll-matmul"))]
        fn.argtypes = [t for t, _ in args] + [vp]
        fn.restype = ctypes.c_int
        rc = fn(*[v for _, v in args], stream)
    build.check(lib, rc, name)
    build.LAUNCHES[COUNTER] += 1
    return out


def check(name: str, got: torch.Tensor, ref: torch.Tensor, inputs) -> dict:
    """How far `got` lies from the plain version's `ref` on `inputs`, and
    whether within the case's bound (module constants): {max_abs_err,
    excess (<= 0: within), ok}."""
    kind = CASES[name].kind
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    if kind == "copy":
        excess = 0.0 if torch.equal(got, ref) else float("inf")
    elif kind == "product":
        a, b = inputs
        if name == "concat-sublanes-49":       # back to z @ w's layout
            n = g.shape[0] // a.shape[0]
            g, r = (t.reshape(n, a.shape[0], -1).transpose(0, 1)
                    .reshape(a.shape[0], -1) for t in (g, r))
        excess = rounding_excess(g, r, a, b, "store")
    elif kind == "tanh":
        bound = ULPS_K6 * 2.0 ** -23 * TANH_SCALE * (1.0 + inputs[1].float()
                                                     .abs())
        excess = (err - bound).max().item()
    else:
        excess = (err.max() - CHAIN_TOL * r.abs().max()).item()
    return {"max_abs_err": err.max().item(), "excess": excess,
            "ok": bool(excess <= 0.0 and torch.isfinite(g).all())}


def case_bound(name: str) -> dict:
    """Least time of the case on an H100: the larger of its bytes (each
    input read once, the output written once) over 3.35e12 B/s and its
    products' operations over the bf16 peak, 989e12 FLOP/s; elementwise
    arithmetic is counted in neither."""
    case = CASES[name]
    nbytes = sum(int(np.prod(s)) * torch.empty(0, dtype=d).element_size()
                 for s, d in case.inputs + (case.out,))
    (m, k), (_, n) = case.inputs[0][0], case.inputs[-1][0]
    flop = {"matmul": 2 * m * k * n, "concat-sublanes-49": 2 * m * k * n,
            "fori-roll-matmul": CHAIN_STEPS * 2 * m * k * n,
            "fori-shift-matmul": CHAIN_STEPS * 2 * m * k * n}.get(name, 0)
    t_bytes, t_ops = nbytes / 3.35e12, flop / 989e12
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bytes": nbytes, "flop": flop}


def device_ms(fn, sync, repeats: int = 3, calls: int = 20) -> float:
    """Median over `repeats` of the mean time of `calls` calls in a row
    (after one warm-up call), host clock around synchronized runs: on a
    card, back-to-back calls' launches overlap the previous call's work."""
    fn()
    times = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    return statistics.median(times)


def run_cases(device="cuda", repeats: int = 3, calls: int = 20,
              names=None) -> list:
    """The script's run: every case once through `diag_case`, held against
    its plain version (`check`), then timed (kernel, plain version and
    the library composition: `device_ms`). One record a case; a case that
    raises or leaves its bound has ok False and its error."""
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    recs = []
    for name in names or CASES:
        rec = {"case": name}
        try:
            inputs = draw_inputs(name, dev)
            out = diag_case(name, *inputs)
            sync()
            rec["sum"] = out.float().sum().item()
            rec.update(check(name, out, diag_case_plain(name, *inputs),
                             inputs))
            del out
            rec["ms"] = device_ms(lambda: diag_case(name, *inputs), sync,
                                  repeats, calls)
            rec["plain_ms"] = device_ms(
                lambda: diag_case_plain(name, *inputs), sync, repeats, calls)
            rec["library_ms"] = device_ms(
                lambda: diag_case_library(name, *inputs), sync, repeats,
                calls)
            rec.update(case_bound(name))
            if not rec["ok"]:
                raise AssertionError(
                    f"max_abs_err {rec['max_abs_err']:.3e} leaves the "
                    f"case's bound by {rec['excess']:.3e}")
            rec["error"] = None
        except Exception as e:           # noqa: BLE001 -- the script's FAIL
            rec["ok"] = False
            rec["error"] = f"{type(e).__name__}: {str(e)[:160]}"
        recs.append(rec)
    return recs


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"devices: {torch.cuda.get_device_name(dev)}", flush=True)
    else:
        print(f"devices: {dev} (the plain versions)", flush=True)
    # the plain versions' times on the CPU are no device metric: one call
    recs = run_cases(dev, **({} if dev.type == "cuda" else
                             dict(repeats=1, calls=1)))
    for r in recs:
        if r["ok"]:
            print(f"PASS {r['case']}: sum={r['sum']:.3e} ms={r['ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} "
                  f"max_abs_err={r['max_abs_err']:.3e}", flush=True)
        else:
            print(f"FAIL {r['case']}: {r['error']}", flush=True)
    if not all(r["ok"] for r in recs):
        raise SystemExit(1)
    return recs
