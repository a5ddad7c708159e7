"""device_idle_pct.serve: the share of the traced window in which no
operation ran on the device (kernels, copies, memsets), from the
profiler's trace."""


def read(run):
    t = run.trace
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)
