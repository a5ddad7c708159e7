"""latency_p95_ms: the 95th percentile (numpy's linear interpolation)
of every request's time from send to predict's return, host clock."""

import numpy as np


def read(run):
    return float(np.percentile(
        [(r["t_done"] - r["t_send"]) * 1e3 for r in run.requests], 95))
