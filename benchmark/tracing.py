"""The traced run's reduction: torch.profiler's trace of a bounded slice
of the window, as the per-layer metrics read it.

The slice is whole requests inside one `bench.window` range, each in a
`bench.request` range; the recorder's pass-through opens a
`bench.reconstruct` range around each projection chunk. The trace is exported as Chrome trace JSON to a
temporary file (TMPDIR) and read back:

  device ops   kernels, memcpys and memsets that start inside the window
  busy         the union of their intervals (seconds in which an
               operation ran on the device)
  a range's    each instance's kernels found through the correlation ids
  device time  of the launches made inside it, then the device's busy
               time from the first of them to the end of the last (cut at
               the end of the request around it), so that kernels of a
               library whose launches the profiler does not correlate are
               counted by their place in the stream; every busy second
               counts once, however the instances' intervals overlap; the
               instance's span runs on to the end of that device work
  idle gaps    the intervals with no device op, each named by the
               innermost host event that covers its middle on the thread
               that opened the window
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function",
             "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
REQUEST = "bench.request"
RECONSTRUCT = "bench.reconstruct"
NAME_CHARS = 160


def export(prof) -> List[Dict]:
    """The profile's complete events ('X'), through a temporary file."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _overlap(xs: List[List[float]], ys: List[List[float]]) -> float:
    """Length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo = max(xs[i][0], ys[j][0])
        hi = min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


class Trace:
    """Times in seconds."""

    def __init__(self, events: List[Dict]):
        wins = [e for e in events if e["name"] == WINDOW
                and e.get("cat") == "user_annotation"]
        if len(wins) != 1:
            raise ValueError(f"{len(wins)} '{WINDOW}' ranges in the trace")
        win = wins[0]
        self.w0, self.w1 = win["ts"], win["ts"] + win["dur"]
        self.tid = win.get("tid")
        self.device = sorted(
            (e["ts"], e["ts"] + e["dur"], e["name"], e.get("cat"),
             (e.get("args") or {}).get("correlation"))
            for e in events if e.get("cat") in DEVICE_CATS
            and self.w0 <= e["ts"] <= self.w1)
        self.launches = [(e["ts"], (e.get("args") or {}).get("correlation"))
                         for e in events if e.get("cat") in LAUNCH_CATS]
        self.ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.host = []
        for e in events:
            if e.get("cat") == "user_annotation":
                self.ranges[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
            if e.get("cat") in HOST_CATS and e.get("tid") == self.tid:
                self.host.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        self.busy = _union([(a, b) for a, b, *_ in self.device])

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def kernel_count(self) -> int:
        return sum(1 for d in self.device if d[3] == "kernel")

    def range_spans(self, name: str) -> Optional[List[Tuple]]:
        """Each instance of range `name`: (host start, end, first, last),
        first .. last the device interval from the first op it launched to
        the end of the last (module docstring), cut at the end of the
        request range around it, if any; end the later of its host end and
        `last`. None when an instance launched no op."""
        requests = self.ranges.get(REQUEST, [])
        spans = []
        for a, b in self.ranges.get(name, []):
            corr = {c for t, c in self.launches
                    if a <= t <= b and c is not None}
            mine = [d for d in self.device if d[4] in corr]
            if not mine:
                return None
            lo = min(d[0] for d in mine)
            hi = max(d[1] for d in mine)
            hi = min([hi] + [e for s_, e in requests if s_ <= a <= e])
            spans.append((a, max(b, hi), lo, hi))
        return spans

    def range_device_s(self, name: str) -> Optional[float]:
        """Device seconds in which an op ran inside the device intervals
        of the instances of `name`, each second counted once."""
        spans = self.range_spans(name)
        if not spans:
            return None
        windows = _union([(lo, hi) for _, _, lo, hi in spans])
        return _overlap(self.busy, windows) * 1e-6

    def self_s(self, parent: str, child: str) -> Optional[List[float]]:
        """For each instance of range `parent`: its length less the spans
        (to the end of their device work) of the `child` ranges in it."""
        kids = self.range_spans(child)
        if kids is None:
            return None
        out = []
        for a, b in self.ranges.get(parent, []):
            inside = sum(min(e, b) - s for s, e, _, _ in kids if a <= s < b)
            out.append((b - a - inside) * 1e-6)
        return out

    def top_ops(self, n: int = 10) -> List[list]:
        by = defaultdict(float)
        for a, b, name, *_ in self.device:
            by[name[:NAME_CHARS]] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle seconds summed by what the host was doing, the largest
        first."""
        edges = [self.w0] + [x for iv in self.busy for x in iv] + [self.w1]
        gaps = sorted((0.5 * (a + b), b - a)
                      for a, b in zip(edges[0::2], edges[1::2]) if b > a)
        host = sorted(self.host)
        by = defaultdict(float)
        stack: list = []      # open host events, innermost last
        i = 0
        for mid, length in gaps:
            while i < len(host) and host[i][0] <= mid:
                while stack and stack[-1][1] < host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "host: no traced event"
            by[name[:NAME_CHARS]] += length * 1e-6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]
