"""sync_idle_ms.serve: the median, over the traced slice's requests, of the
device idle time inside the request's `pipeline.sync` spans (each
chunk's copies to the host), summed per request."""

from benchmark import program_spans


def read(run):
    return program_spans.median_ms(program_spans.sync_idle(run.trace))
