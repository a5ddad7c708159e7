"""latency_p50_ms: the median of every request's time from send to
predict's return, host clock."""

import numpy as np


def read(run):
    return float(np.median(
        [(r["t_done"] - r["t_send"]) * 1e3 for r in run.requests]))
