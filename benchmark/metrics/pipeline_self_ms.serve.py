"""pipeline_self_ms.serve: the median, over the traced slice's requests,
of predict's time less the time inside DefenseGAN.reconstruct, each
reconstruct call counted to the end of the device work it launched (the
profiler's trace): the pipeline's own work, its classifier and host
syncs."""

import numpy as np

from benchmark import tracing


def read(run):
    t = run.trace
    own = None if t is None else t.self_s(tracing.REQUEST,
                                          tracing.RECONSTRUCT)
    return float(np.median(own)) * 1e3 if own else None
