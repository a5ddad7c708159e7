"""projection_roofline: the generator's own FLOPs (benchmark/flops.py:
fc and every transpose conv, forward and input gradient, products that
land inside the output) for the image rows handed to reconstruct in the
traced slice, over the device time of the ops those calls launched times
the card's bf16 peak. The work is compute-bound: its bytes, read once,
are far below the ridge. None on a card the peak table does not name."""

from benchmark import tracing


def read(run):
    t = run.trace
    if t is None or run.peak_bf16 is None:
        return None
    busy = t.range_device_s(tracing.RECONSTRUCT)
    rows = sum(r["rows"] for r in run.requests if r["profiled"])
    if not busy or not rows:
        return None
    return 100.0 * rows * run.image_flops / (busy * run.peak_bf16)
