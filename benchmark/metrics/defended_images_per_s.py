"""defended_images_per_s: images that predict returned (purified,
classified, flagged) over the whole window, from the first request's
send to the return of the last (whole requests)."""


def read(run):
    reqs = run.requests
    return sum(r["n"] for r in reqs) / (reqs[-1]["t_done"]
                                         - reqs[0]["t_send"])
