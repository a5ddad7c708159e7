"""loop_device_ms.serve: the median, over the traced slice's requests, of
the device busy time of the request's L-step loops: each
`projection.loop` span from the first device op launched inside it to
the first launched after it, every busy second counted once
(benchmark/program_spans.py)."""

from benchmark import program_spans


def read(run):
    return program_spans.median_ms(program_spans.loop_device(run.trace))
