"""Tracing, per-phase wall-clock totals and a non-finite guard (port of
the JAX package's utils/profiling.py).

  - `trace(logdir)`: a torch.profiler scope that writes a Chrome trace
    (chrome://tracing, Perfetto) of everything inside it under logdir;
  - `span(name)`: a named range of the request path (pipeline.predict,
    batching.chunk, gan.reconstruct, projection.encode, projection.loop,
    ...), recorded into the trace of whatever torch.profiler is
    recording, on the clock of its device records, and nested as the
    calls nest; with no profiler recording it is a shared no-op context;
  - `recording()`: whether a torch.profiler records on this thread;
  - `device_rows(prof)`: a finished profile's device work by name (the
    kernels, copies and fills), without the device-side copies of the
    ranges that launched it;
  - `PhaseTimer`: per-phase wall-clock aggregation. The device runs
    asynchronously: a phase that ends on CUDA work is closed after
    torch.cuda.synchronize(), so its time is the device's, not the
    enqueue's;
  - `nan_guard()`: raise on a non-finite value produced inside the scope,
    in the forward (every torch operation's floating outputs are checked)
    and in the backward (torch.autograd.detect_anomaly).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode


@contextlib.contextmanager
def trace(logdir: str = "output/traces") -> Iterator[str]:
    """Profile everything inside the scope (the CPU, and CUDA where a
    device is present) and write it as a Chrome trace into logdir; yields
    the trace file's path (written when the scope exits)."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


_NO_SPAN = contextlib.nullcontext()


def recording() -> bool:
    """Whether a torch.profiler records on this thread (a tenth of a
    microsecond to ask)."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A torch.profiler range named `name` while a profiler records (on
    this thread), else a shared no-op context: an idle record_function
    costs tens of microseconds, the check a tenth of one."""
    if recording():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def device_rows(prof) -> List[Tuple[str, float, int]]:
    """(name, device us, count) of each row of prof.key_averages() that
    is device work. With CUDA activity on, the profiler also gives each
    named range (a span, any record_function) that launched device work
    a device-side row as long as the range: such rows (user annotations)
    are left out, so that no device time is counted twice."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total",
                     getattr(e, "cuda_time_total", 0.0))
        if us > 0 and e.self_cpu_time_total == 0 and \
                not getattr(e, "is_user_annotation", False):
            rows.append((e.key, us, e.count))
    return rows


class _NonFiniteCheck(TorchFunctionMode):
    """Raise FloatingPointError when a torch operation returns a floating
    tensor with a NaN or an infinity."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and \
                    not bool(torch.isfinite(t).all()):
                name = getattr(func, "__name__", func)
                raise FloatingPointError(f"non-finite value produced by "
                                         f"{name}")
        return out


@contextlib.contextmanager
def nan_guard(enable: bool = True) -> Iterator[None]:
    """Raise on a non-finite value produced inside the scope: in the
    forward a FloatingPointError naming the operation, in a backward run
    inside the scope autograd's anomaly error (RuntimeError) naming the
    backward function."""
    if not enable:
        yield
        return
    with torch.autograd.detect_anomaly(check_nan=True), _NonFiniteCheck():
        yield


class PhaseTimer:
    """Accumulate wall-clock per phase.

    device: the phase's CUDA device (or None): on a CUDA device every
    phase ends with torch.cuda.synchronize(device) before the clock is
    read.
    """

    def __init__(self, device: Optional[torch.device] = None):
        self.device = torch.device(device) if device is not None else None
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        """Fold an externally measured duration into the phase totals."""
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(v, 4), "count": self.counts[k],
                    "mean_s": round(v / max(self.counts[k], 1), 4)}
                for k, v in self.totals.items()}

    def __str__(self) -> str:
        return " | ".join(f"{k}: {v:.3f}s/{self.counts[k]}"
                          for k, v in self.totals.items())
