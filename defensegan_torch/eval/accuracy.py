"""(Defended) accuracy evaluation and the batched reconstruction every
defended consumer shares (port of the JAX package's eval/accuracy.py).

Reference parity: cleverhans model_eval and
utils/gan_defense.py::model_eval_gan of kabkabm/defensegan, which pushes
each test batch through the reconstruction before the classifier.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from defensegan_torch.utils.profiling import span


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

    - batch_size None cuts x into chunks of at most 1024 images and pads
      none beyond what the device layout needs: a gan sharded over a mesh
      of d devices gets each chunk's rows rounded up to a multiple of d
      (parallel/mesh.py::validate_projection_sharding), one device the
      images alone; rows below a kernel's tile are the kernel wrapper's
      to pad;
    - an explicit batch_size cuts chunks of that size and zero-pads the
      last one to it;
    - padded rows are zeros: slice the per-example fields of `res` with
      [: hi - lo];
    - restart draws come from the torch.Generator `gen`, in chunk order,
      unless z0_fn(lo) hands back at least the chunk's rows of z0
      [rows, R, k] (an exact replay, e.g. of another package's draws),
      cropped to the chunk's rows;
    - rec_* / rec_kernel / rec_init pass through to gan.reconstruct;
    - under a torch.profiler each chunk's staging and reconstruction is
      a batching.chunk span, closed before the chunk is yielded.
    """
    n = x.shape[0]
    grain = len(getattr(gan, "mesh", ())) or 1
    for lo, hi in _batches(n, batch_size or min(1024, n)):
        with span("batching.chunk"):
            xb = torch.as_tensor(x[lo:hi], device=gan.device)
            rows = batch_size or -(-(hi - lo) // grain) * grain
            pad = rows - xb.shape[0]
            if pad:
                xb = torch.cat([xb, xb.new_zeros((pad,) + xb.shape[1:])])
            z0 = z0_fn(lo)[:rows] if z0_fn is not None else None
            res = gan.reconstruct(xb, gen, rec_rr=rec_rr,
                                  rec_iters=rec_iters, rec_lr=rec_lr,
                                  kernel=rec_kernel, init=rec_init, z0=z0)
        yield res, lo, hi


def to_numpy(t: torch.Tensor, dtype=np.float64) -> np.ndarray:
    return t.detach().to("cpu").numpy().astype(dtype)


LogitsFn = Callable[[torch.Tensor], torch.Tensor]


@torch.no_grad()
def model_eval(logits_fn: LogitsFn, x, y, batch_size: int = 256) -> float:
    """Plain accuracy (reference: cleverhans model_eval)."""
    correct = 0
    for lo, hi in _batches(x.shape[0], batch_size):
        pred = torch.argmax(logits_fn(torch.as_tensor(x[lo:hi])), dim=-1)
        correct += int((pred.cpu() == torch.as_tensor(y[lo:hi])).sum())
    return correct / x.shape[0]


@torch.no_grad()
def model_eval_gan(gan, logits_fn: LogitsFn, x, y,
                   gen: Optional[torch.Generator] = None,
                   batch_size: Optional[int] = None,
                   rec_rr: Optional[int] = None,
                   rec_iters: Optional[int] = None,
                   rec_lr: Optional[float] = None,
                   rec_kernel: Optional[str] = None,
                   rec_init: Optional[str] = None,
                   z0_fn: Optional[Callable[[int], torch.Tensor]] = None,
                   return_correct: bool = False):
    """Defended accuracy: purify each batch with gan.reconstruct (the
    resolver's path: a fused kernel on CUDA), then classify.

    Batching, padding, draws and overrides are batched_reconstruct's; the
    padding is excluded from the count. return_correct=True also returns
    the per-example bool array [N] (joined with detection flags by the
    white-box CLI's --detect).
    """
    correct = []
    for res, lo, hi in batched_reconstruct(gan, x, gen=gen,
                                           batch_size=batch_size,
                                           rec_rr=rec_rr,
                                           rec_iters=rec_iters,
                                           rec_lr=rec_lr,
                                           rec_kernel=rec_kernel,
                                           rec_init=rec_init, z0_fn=z0_fn):
        pred = torch.argmax(logits_fn(res.x_hat[:hi - lo]), dim=-1)
        correct.append(pred.cpu().numpy() == np.asarray(y[lo:hi]))
    correct = np.concatenate(correct)
    acc = float(correct.mean())
    return (acc, correct) if return_correct else acc
