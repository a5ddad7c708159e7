"""Batched reconstruction for every defended consumer (port of
eval/accuracy.py::batched_reconstruct; the accuracy evaluations come with
the attacks slice)."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _batches(n: int, batch_size: int):
    for i in range(0, n, batch_size):
        yield i, min(i + batch_size, n)


def batched_reconstruct(gan, x, gen: Optional[torch.Generator] = None,
                        batch_size: Optional[int] = None,
                        rec_rr: Optional[int] = None,
                        rec_iters: Optional[int] = None,
                        rec_lr: Optional[float] = None,
                        rec_kernel: Optional[str] = None,
                        rec_init: Optional[str] = None,
                        z0_fn: Optional[Callable[[int], torch.Tensor]] = None):
    """Yield (res, lo, hi) reconstruction batches over x (numpy or torch).

    - batch_size None picks min(1024, n rounded up to 256): wide batch x
      restarts for full kernel tiles, few calls;
    - the last partial batch is zero-padded to the batch size — slice the
      per-example fields of `res` with [: hi - lo];
    - restart draws come from the torch.Generator `gen`, in batch order,
      unless z0_fn(lo) hands back the batch's z0 [batch_size, R, k] (an
      exact replay, e.g. of another package's draws);
    - rec_* / rec_kernel / rec_init pass through to gan.reconstruct.
    """
    n = x.shape[0]
    if batch_size is None:
        batch_size = min(1024, ((n + 255) // 256) * 256)
    for lo, hi in _batches(n, batch_size):
        xb = torch.as_tensor(x[lo:hi], device=gan.device)
        pad = batch_size - xb.shape[0]
        if pad:
            xb = torch.cat([xb, xb.new_zeros((pad,) + tuple(xb.shape[1:]))])
        z0 = z0_fn(lo) if z0_fn is not None else None
        res = gan.reconstruct(xb, gen, rec_rr=rec_rr, rec_iters=rec_iters,
                              rec_lr=rec_lr, kernel=rec_kernel,
                              init=rec_init, z0=z0)
        yield res, lo, hi


def to_numpy(t: torch.Tensor, dtype=np.float64) -> np.ndarray:
    return t.detach().to("cpu").numpy().astype(dtype)
