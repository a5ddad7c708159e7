"""predict_idle_ms.serve: the median, over the traced slice's requests, of
the device idle time inside each `pipeline.predict` span of the program:
its length less the device busy time it overlaps (the profiler's trace,
one clock)."""

from benchmark import program_spans


def read(run):
    return program_spans.median_ms(program_spans.predict_idle(run.trace))
