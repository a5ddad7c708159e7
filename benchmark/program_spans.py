"""The program's own spans in a traced run (defensegan_torch/utils/
profiling.py::span), read against the device's busy time on the same
clock: per request, that is per `pipeline.predict` instance of the
traced slice,

  predict idle   the instance's length less the device busy time it
                 overlaps
  sync idle      the same, summed over the `pipeline.sync` instances
                 (a chunk's copies to the host) inside it, outside the
                 request's loop windows (below): the device's wait on the
                 host's syncs once the loop's work is done, and not the
                 gaps between the loop's kernels that fall while the host
                 waits in a chunk's first copy, so that a faster loop
                 leaves it where it was
  loop device    the device busy time of its loop windows: its
                 `projection.loop` instances, each from the first device
                 op launched inside it to the first device op launched
                 after it (the selection's): the library's kernels count
                 by their place in the stream, whether or not the
                 profiler ties their launches (made through the
                 library's own runtime) to the span; a span to which it
                 tied no op counts from its own start; every busy second
                 counts once

Each reading is a list over the requests, in seconds, or None when the
trace holds no such span (a program without them).
"""

from __future__ import annotations

import bisect
from typing import List, Optional

import numpy as np

from benchmark.tracing import Trace, _overlap, _union

PREDICT = "pipeline.predict"
SYNC = "pipeline.sync"
LOOP = "projection.loop"


def _requests(t: Trace):
    return [(a, b) for a, b in t.ranges.get(PREDICT, [])
            if t.w0 <= a and b <= t.w1]


def _inside(t: Trace, name: str, a: float, b: float):
    return [(s, e) for s, e in t.ranges.get(name, []) if a <= s and e <= b]


def _idle(t: Trace, a: float, b: float) -> float:
    return (b - a) - _overlap(t.busy, [[a, b]])


def predict_idle(t: Optional[Trace]) -> Optional[List[float]]:
    reqs = [] if t is None else _requests(t)
    return [_idle(t, a, b) * 1e-6 for a, b in reqs] or None


def _less(xs: List[List[float]], ys: List[List[float]]):
    """The sorted, disjoint intervals xs less the sorted, disjoint ys."""
    out = []
    for a, b in xs:
        for c, d in ys:
            if d <= a or c >= b:
                continue
            if c > a:
                out.append([a, c])
            a = max(a, d)
            if a >= b:
                break
        if a < b:
            out.append([a, b])
    return out


def _loop_windows(t: Trace, reqs) -> List[List[List[float]]]:
    """Each request's loop windows (module docstring), merged."""
    start = {}                  # correlation id -> its device op's start
    for a, _, _, _, c in t.device:
        if c is not None:
            start[c] = min(a, start.get(c, a))
    launches = sorted((ts, c) for ts, c in t.launches if c in start)
    times = [ts for ts, _ in launches]
    out = []
    for a, b in reqs:
        windows = []
        for s, e in _inside(t, LOOP, a, b):
            i, j = bisect.bisect_left(times, s), bisect.bisect_right(times, e)
            lo = min((start[c] for _, c in launches[i:j]), default=s)
            hi = start[launches[j][1]] if j < len(launches) else b
            windows.append((lo, min(hi, b)))
        out.append(_union(windows))
    return out


def sync_idle(t: Optional[Trace]) -> Optional[List[float]]:
    reqs = [] if t is None else _requests(t)
    if not any(_inside(t, SYNC, a, b) for a, b in reqs):
        return None
    out = []
    for (a, b), loops in zip(reqs, _loop_windows(t, reqs)):
        rest = _less(_union(_inside(t, SYNC, a, b)), loops)
        out.append((sum(e - s for s, e in rest)
                    - _overlap(t.busy, rest)) * 1e-6)
    return out


def loop_device(t: Optional[Trace]) -> Optional[List[float]]:
    reqs = [] if t is None else _requests(t)
    if not any(_inside(t, LOOP, a, b) for a, b in reqs):
        return None
    return [_overlap(t.busy, w) * 1e-6 for w in _loop_windows(t, reqs)]


def median_ms(values: Optional[List[float]]) -> Optional[float]:
    return float(np.median(values)) * 1e3 if values else None
