"""useful_rows_pct.serve: images requested over image rows handed to
DefenseGAN.reconstruct (the batching's padding), over the window."""


def read(run):
    rows = sum(r["rows"] for r in run.requests)
    return 100.0 * sum(r["n"] for r in run.requests) / rows if rows else None
