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

`diag_case` runs a case (`diag_case_into` into a given output): on CUDA
tensors through its hand-written kernel (csrc/v3_diag.cu: the four
products on the port's wgmma GEMM with the row moves in their stores, the
rest one pass each of 16-byte vectors), on CPU tensors through
`diag_case_plain`. A CUDA call is one ctypes call: each case's entry,
argument types and scalars (a DiagDims, passed by address) are a row of
CALLS, bound once, and the wrapper checks only shape, type, device and
contiguity. `check` holds a result against the plain version (the bounds
below), `run_cases` is the script's run (scripts/pallas_v3_diag_torch.py):
every case once, checked, timed on the host clock and the card's
(host_rounds, events_ms); `launch_costs` times the launch path's floor.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import time
from typing import Callable, NamedTuple, Optional

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
    """One cuBLAS bf16 product, in bf16 as the library returns it (the
    yardstick only; the composition takes it to float32)."""
    return torch.matmul(a, b)


def _compose(name: str, inputs, mm: Callable, out=None) -> torch.Tensor:
    """The case of PyTorch ops, products by `mm`; `out`: the result
    written into it by the last op (its out=, or copy_ in place of the
    last cast to float32)."""
    def to_f32(t):
        return t.float() if out is None else out.copy_(t)

    if name == "matmul":
        return to_f32(mm(*inputs))
    if name == "concat-sublanes-49":
        z, w = inputs
        return torch.cat([mm(z, w[:, p * C0:(p + 1) * C0]).float()
                          for p in range(w.shape[1] // C0)], out=out)
    if name == "roll-bf16":
        return to_f32(roll_rows(inputs[0], ROLL_SHIFT))
    if name == "mask-lane-slice":
        a, m = inputs
        return torch.mul(a, m[:, MASK_COL:MASK_COL + 1], out=out)
    if name == "concat-lanes-9x16":
        a = inputs[0]
        return torch.cat([roll_rows(a, k * T % a.shape[0])
                          for k in range(LANES)], dim=1, out=out)
    if name == "narrow-elementwise":
        a, b = inputs
        t = torch.tanh(a.float())
        return torch.mul((t - b.float()) * (1.0 - t * t), TANH_SCALE,
                         out=out)
    if name in ("fori-roll-matmul", "fori-shift-matmul"):
        move = roll_rows if name == "fori-roll-matmul" else shift_rows
        a, b = inputs
        acc = a.float()
        for i in range(CHAIN_STEPS):
            acc = mm(move(acc.to(torch.bfloat16), T), b)
            acc = acc.float() if i + 1 < CHAIN_STEPS else to_f32(acc)
        return acc
    if name == "shift-slice-concat":
        a = inputs[0]
        return torch.add(shift_rows(a, SHIFTS[0]).float(),
                         shift_rows(a, SHIFTS[1]).float(), out=out)
    if name == "concat-lanes-norolls":
        return torch.cat([inputs[0]] * LANES, dim=1, out=out)
    raise ValueError(f"no case {name!r}: one of {sorted(CASES)}")


def diag_case_plain(name: str, *inputs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of case `name` (products in float32)."""
    return _compose(name, inputs, _mm_f32)


def diag_case_library(name: str, *inputs: torch.Tensor,
                      out=None) -> torch.Tensor:
    """The case composed of PyTorch's own calls, its products on cuBLAS in
    bf16: the yardstick, never called by the port. `out`: as
    diag_case_into's, written by the composition's last op."""
    return _compose(name, inputs, _mm_library, out)


class DiagDims(ctypes.Structure):
    """csrc/v3_diag.cu's DiagDims: a case's scalar arguments, passed by
    address (each entry reads its own fields: rows and cols of the output
    or its source, up to three more ints, the tanh case's scale)."""
    _fields_ = [("rows", ctypes.c_int), ("cols", ctypes.c_int),
                ("a", ctypes.c_int), ("b", ctypes.c_int),
                ("c", ctypes.c_int), ("scale", ctypes.c_float)]


class Call(NamedTuple):
    """How a case reaches its kernel: one call of `entry` (an extern "C"
    function of csrc/v3_diag.cu) with the inputs' pointers, the output's,
    `scratch` bf16 buffers of the output's shape (the chains'), the
    address of its DiagDims (`dims`: rows, cols, a, b, c, scale) and the
    stream, bound with `argtypes`."""
    entry: str
    argtypes: tuple
    dims: tuple
    scratch: int = 0


def _ptrs(n: int) -> tuple:
    """n pointers, then the DiagDims and the stream (all void*)."""
    return (ctypes.c_void_p,) * (n + 2)


_vp = ctypes.c_void_p
CALLS = {
    "matmul": Call("fp_diag_matmul", _ptrs(3), (ROWS, CA, C0, 0, 0, 0.0)),
    "concat-sublanes-49": Call("fp_diag_matmul", _ptrs(3),
                               (T, P2 * C0, C0, C0, 0, 0.0)),
    "roll-bf16": Call("fp_diag_roll_f32", _ptrs(2),
                      (ROWS, C0, ROLL_SHIFT, 0, 0, 0.0)),
    "mask-lane-slice": Call("fp_diag_mask_col", _ptrs(3),
                            (ROWS, C0, 9, MASK_COL, 0, 0.0)),
    "concat-lanes-9x16": Call("fp_diag_lane_concat", _ptrs(2),
                              (ROWS, CB, LANES, T, 0, 0.0)),
    "narrow-elementwise": Call("fp_diag_tanh_grad", _ptrs(3),
                               (ROWS, CB, 0, 0, 0, TANH_SCALE)),
    "fori-roll-matmul": Call("fp_diag_chain", _ptrs(5),
                             (ROWS, C0, CHAIN_STEPS, T, 1, 0.0), scratch=2),
    "shift-slice-concat": Call("fp_diag_shift_sum", _ptrs(2),
                               (ROWS, C0) + SHIFTS + (0, 0.0)),
    "concat-lanes-norolls": Call("fp_diag_lane_concat", _ptrs(2),
                                 (ROWS, CB, LANES, 0, 0, 0.0)),
    "fori-shift-matmul": Call("fp_diag_chain", _ptrs(5),
                              (ROWS, C0, CHAIN_STEPS, T, 0, 0.0), scratch=2),
}
# the launch path's floor (launch_costs): no work, one empty kernel, a spin
HELPERS = {"fp_diag_nop": (), "fp_diag_empty": (_vp,),
           "fp_diag_spin": (ctypes.c_longlong, _vp)}

_BOUND: dict = {}         # (library, entry) -> its ctypes function


def bind(entry: str, argtypes: tuple, library: str = LIBRARY,
         restype=ctypes.c_int):
    """A kernel library's extern "C" function with its argument types
    set, bound once (building the library at first use)."""
    fn = _BOUND.get((library, entry))
    if fn is None:
        fn = getattr(build.load(library), entry)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _BOUND[library, entry] = fn
    return fn


# the cudaStream_t of device `index`'s current stream as an int, and the
# current device: torch's own fast paths where it has them, else the
# public calls (the wrappers' host time is the probes' metric, and
# torch.cuda.current_stream(i).cuda_stream alone takes about 5 us of it)
stream_ptr = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)
_current_device = getattr(torch._C, "_cuda_getDevice", None) or \
    torch.cuda.current_device


def launch(fn, args, index: int) -> int:
    """fn(*args, stream) on device `index`: under a device guard only when
    that device is not the current one (a kernel launches on the current
    device, and the GEMM reads its SM count)."""
    if index == _current_device():
        return fn(*args, stream_ptr(index))
    with torch.cuda.device(index):
        return fn(*args, stream_ptr(index))


def _check_inputs(name: str, inputs, out=None) -> int:
    """The inputs' card (its index), or -1 for the CPU; raise unless they
    are the case's shapes and types, contiguous, on one device, the CPU
    or a card, and `out` (if given) the output's, beside them and apart
    from them. Every call's only validation: four attributes a tensor."""
    case = CASES.get(name)
    if case is None:
        raise ValueError(f"no case {name!r}: one of {sorted(CASES)}")
    if len(inputs) != len(case.inputs):
        raise ValueError(f"{name} takes {len(case.inputs)} inputs")
    index = inputs[0].get_device()
    for t, spec in zip(inputs, case.inputs):
        if (t.shape, t.dtype) != spec or t.get_device() != index or \
                not t.is_contiguous():
            raise ValueError(f"{name}: every input a contiguous {spec[0]} "
                             f"{spec[1]} on {inputs[0].device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if out is not None:
        if (out.shape, out.dtype) != case.out or \
                out.get_device() != index or not out.is_contiguous():
            raise ValueError(f"{name}: out a contiguous {case.out[0]} "
                             f"{case.out[1]} on {inputs[0].device}, got "
                             f"{tuple(out.shape)} {out.dtype} on "
                             f"{out.device}")
        lo = out.data_ptr()
        hi = lo + out.nbytes
        for t in inputs:
            if t.data_ptr() < hi and lo < t.data_ptr() + t.nbytes:
                raise ValueError(f"{name}: out overlaps an input")
    if index < 0:                       # the CPU, or no card at all
        devs = {t.device.type for t in inputs}
        if devs != {"cpu"}:
            raise ValueError(f"{name}: inputs on {sorted(devs)}, neither "
                             f"the CPU nor a card" if "cpu" not in devs
                             else f"{name}: inputs on {sorted(devs)}, not "
                             f"on one device")
        if out is not None and out.device.type != "cpu":
            raise ValueError(f"{name}: out on {out.device}, the inputs on "
                             f"the CPU")
    return index


class _Ready(NamedTuple):
    """A case's call on one card, made once: the bound function, the
    address of its DiagDims (`keep` holds the struct), and one-element
    tensors on the card expanded to the output's shape and type (and the
    chains' scratch's), which torch.empty_like allocates from: a
    contiguous tensor from torch's caching allocator on the current
    stream, at less host cost than torch.empty's shape, type and device
    arguments."""
    fn: Callable
    dims: ctypes.c_void_p
    keep: DiagDims
    out: torch.Tensor
    scratch: Optional[torch.Tensor]


_READY: dict = {}           # (case, card index) -> _Ready
_LAUNCHES = build.LAUNCHES


def _ready(name: str, index: int) -> _Ready:
    call, (shape, dtype) = CALLS[name], CASES[name].out
    dev = torch.device("cuda", index)
    keep = DiagDims(*call.dims)
    scratch = torch.empty((), dtype=_bf, device=dev).expand(
        (call.scratch,) + shape) if call.scratch else None
    ready = _READY[name, index] = _Ready(
        bind(call.entry, call.argtypes),
        ctypes.c_void_p(ctypes.addressof(keep)), keep,
        torch.empty((), dtype=dtype, device=dev).expand(shape), scratch)
    return ready


def diag_case(name: str, *inputs: torch.Tensor) -> torch.Tensor:
    """Case `name` on its inputs (draw_inputs' shapes and types), into a
    new output: diag_case_into(None, name, *inputs)."""
    return diag_case_into(None, name, *inputs)


def diag_case_into(out, name: str, *inputs: torch.Tensor) -> torch.Tensor:
    """Case `name` on its inputs into `out`, returned: the kernel on CUDA
    tensors (or raise), the plain version on CPU tensors. `out` is a
    contiguous tensor of the output's shape and type beside the inputs,
    not overlapping them, or None for a new one. A CUDA call checks its
    tensors (`_check_inputs`), allocates what it needs (the output where
    none is given, a chain's scratch, freed to torch's allocator on
    return as an op's temporaries are) and makes one ctypes call (CALLS,
    bound at the case's first call on the card) on the current stream."""
    index = _check_inputs(name, inputs, out)
    if index < 0:
        res = diag_case_plain(name, *inputs)
        return res if out is None else out.copy_(res)
    ready = _READY.get((name, index)) or _ready(name, index)
    if out is None:
        out = torch.empty_like(ready.out)
    args = [t.data_ptr() for t in inputs]
    args.append(out.data_ptr())
    if ready.scratch is not None:
        scratch = torch.empty_like(ready.scratch)
        args += [s.data_ptr() for s in scratch]
    args.append(ready.dims)
    rc = launch(ready.fn, args, index)
    if rc:
        build.check(build.load(LIBRARY), rc, name)
    _LAUNCHES[COUNTER] += 1
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


def host_rounds(fns: dict, sync, repeats: int = 3,
                calls: int = 20) -> dict:
    """{key: [ms, one a round]} for each function of `fns`: the mean time
    of `calls` calls in a row (after one warm-up call each), host clock
    around synchronized runs, in `repeats` rounds. The functions take
    turns within a round, so that a drift of the host's speed falls on all
    alike, and a round's times of two functions pair up. On a card
    back-to-back calls' launches overlap the previous call's work: a call
    costs the larger of its host and device times."""
    for fn in fns.values():
        fn()
    times = {key: [] for key in fns}
    for _ in range(repeats):
        for key, fn in fns.items():
            sync()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            sync()
            times[key].append((time.perf_counter() - t0) * 1e3 / calls)
    return times


def host_ms(fns: dict, sync, repeats: int = 3, calls: int = 20) -> dict:
    """{key: ms}: the median over the rounds of host_rounds."""
    return {key: statistics.median(t) for key, t in
            host_rounds(fns, sync, repeats, calls).items()}


def paired_ratio(num: list, den: list) -> dict:
    """Round by round num / den (host_rounds' times of two functions):
    their median (`ratio`), the smallest and the largest, and the share of
    rounds above 1."""
    r = sorted(a / b for a, b in zip(num, den))
    return {"ratio": statistics.median(r), "min": r[0], "max": r[-1],
            "above_1": sum(x > 1.0 for x in r) / len(r)}


def events_ms(fn, device, host: float, repeats: int = 3,
              calls: int = 20) -> float:
    """Device time of one call, ms: CUDA events around `calls` calls in a
    row, queued behind a spin kernel that lasts twice their host time
    `host` (ms a call) and at least 1 ms, so that the card takes them back
    to back; the median of `repeats`."""
    spin = bind("fp_diag_spin", HELPERS["fp_diag_spin"])
    ns = int(max(2e6 * calls * host, 1e6))
    dev = torch.device(device)
    with torch.cuda.device(dev):
        index = torch.cuda.current_device()
        fn()
        times = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            build.check(build.load(LIBRARY), launch(spin, [ns], index),
                        "spin")
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def launch_costs(device="cuda", calls: int = 1000) -> dict:
    """The launch path's floor on the card, in microseconds a call: a bare
    ctypes call into the library (no CUDA call), a ctypes call that
    launches an empty kernel (host time) and that kernel back to back on
    the card (events), against one torch op's dispatch (an in-place add on
    one element) on the host and on the card. `calls` calls in a row,
    median of 3 (host_ms, events_ms)."""
    dev = torch.device(device)
    nop = bind("fp_diag_nop", HELPERS["fp_diag_nop"])
    empty = bind("fp_diag_empty", HELPERS["fp_diag_empty"])
    one = torch.zeros(1, device=dev)
    with torch.cuda.device(dev):
        st = stream_ptr(torch.cuda.current_device())
        fns = {"bare_ctypes": nop, "empty_kernel": lambda: empty(st),
               "torch_op": lambda: one.add_(1.0)}
        host = host_ms(fns, torch.cuda.synchronize, calls=calls)
        out = {f"{k}_host_us": v * 1e3 for k, v in host.items()}
        for key in ("empty_kernel", "torch_op"):
            out[f"{key}_device_us"] = 1e3 * events_ms(
                fns[key], dev, host[key], calls=calls)
    return out


def run_cases(device="cuda", repeats: int = 3, calls: int = 20,
              names=None) -> list:
    """The script's run: every case once through `diag_case`, held against
    its plain version (`check`) and, into a given output, bit for bit the
    same (out_equal); then timed on the host clock in turns
    (host_rounds; each time the median of the rounds): the kernel (ms),
    the kernel into a given output (diag_case_into: out_ms), the plain
    version
    (plain_ms), the library composition (library_ms) and the composition
    into the same output (library_out_ms). vs_library is out_ms over
    library_out_ms round by round (paired_ratio): the launch path and the
    kernel against torch's dispatch and kernels, neither allocating the
    output; vs_library_alloc the same of ms and library_ms, each
    allocating it. On a card also the kernel's and the library
    composition's device times (`events_ms`: device_ms,
    library_device_ms). One record a case; a case that raises or leaves
    its bound has ok False and its error."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
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
            buf = torch.empty_like(out)
            rec["out_equal"] = bool(torch.equal(
                diag_case_into(buf, name, *inputs), out))
            del out
            fns = {"ms": lambda: diag_case(name, *inputs),
                   "out_ms": lambda: diag_case_into(buf, name, *inputs),
                   "plain_ms": lambda: diag_case_plain(name, *inputs),
                   "library_ms": lambda: diag_case_library(name, *inputs),
                   "library_out_ms": lambda: diag_case_library(
                       name, *inputs, out=buf)}
            rounds = host_rounds(fns, sync, repeats, calls)
            rec.update({k: statistics.median(t) for k, t in rounds.items()})
            rec["vs_library"] = paired_ratio(rounds["out_ms"],
                                             rounds["library_out_ms"])
            rec["vs_library_alloc"] = paired_ratio(rounds["ms"],
                                                   rounds["library_ms"])
            for key, dkey in (("ms", "device_ms"),
                              ("library_ms", "library_device_ms")):
                rec[dkey] = events_ms(fns[key], dev, rec[key], repeats,
                                      calls) if cuda else None
            rec.update(case_bound(name))
            if not rec["ok"]:
                raise AssertionError(
                    f"max_abs_err {rec['max_abs_err']:.3e} leaves the "
                    f"case's bound by {rec['excess']:.3e}")
            if not rec["out_equal"]:
                raise AssertionError("the call into a given output differs "
                                     "from the allocating call")
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
            dev_ms = "" if r["device_ms"] is None else \
                f" device_ms={r['device_ms']:.4f}"
            print(f"PASS {r['case']}: sum={r['sum']:.3e} ms={r['ms']:.4f}"
                  f"{dev_ms} plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']:.4f} "
                  f"vs_library={r['vs_library']['ratio']:.3f} "
                  f"max_abs_err={r['max_abs_err']:.3e}", flush=True)
        else:
            print(f"FAIL {r['case']}: {r['error']}", flush=True)
    if not all(r["ok"] for r in recs):
        raise SystemExit(1)
    return recs
