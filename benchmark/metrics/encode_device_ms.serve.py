"""encode_device_ms.serve: the median, over the traced slice's requests,
of the device busy time of the encoder start: the device ops launched
inside the request's `projection.encode` spans (E(x) and the merge into
restart 0), tied to them by the profiler's correlation ids, every busy
second counted once. None for a program without the span."""

from benchmark import program_spans
from benchmark.tracing import _union


def encode_device(t):
    """The encoder-start device seconds of each request that has the
    span, or None when none has it."""
    reqs = [] if t is None else program_spans._requests(t)
    spans = [program_spans._inside(t, "projection.encode", a, b)
             for a, b in reqs]
    if not any(spans):
        return None
    start = {}
    for a, b, _, _, c in t.device:
        if c is not None:
            start.setdefault(c, []).append((a, b))
    out = []
    for inside in filter(None, spans):
        ops = [iv for ts, c in t.launches
               if any(s <= ts <= e for s, e in inside)
               for iv in start.get(c, [])]
        out.append(sum(b - a for a, b in _union(ops)) * 1e-6)
    return out


def read(run):
    return program_spans.median_ms(encode_device(run.trace))
