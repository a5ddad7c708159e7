"""kernels_per_request.serve: device kernels the profiler recorded in
the traced slice, per request of the slice."""


def read(run):
    t = run.trace
    n = sum(1 for r in run.requests if r["profiled"])
    return t.kernel_count() / n if t is not None and n else None
