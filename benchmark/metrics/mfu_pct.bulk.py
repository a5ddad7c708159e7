"""mfu_pct.bulk: the generator's own FLOPs for the images predict
returned, over the time of the traced run's requests outside the
profiled slice times the card's bf16 peak: the whole step's share of the
chip, which bounds every kernel's gain. None on a card the peak table
does not name."""


def read(run):
    reqs = run.unprofiled()
    if run.peak_bf16 is None or not reqs:
        return None
    secs = sum(r["t_done"] - r["t_send"] for r in reqs)
    return 100.0 * sum(r["n"] for r in reqs) * run.image_flops / (
        secs * run.peak_bf16)
