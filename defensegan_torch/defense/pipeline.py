"""Defense-in-depth serving pipeline: purify -> classify -> flag (port of
the JAX package's defense/pipeline.py).

One projection pass per input serves both layers: the reconstruction that
purifies is the computation whose final loss is the detection statistic.

    pipe = DefendedPipeline(gan, logits_fn, fpr=0.05)
    pipe.calibrate(x_clean_heldout)     # clean rec-err quantiles
    out = pipe.predict(x)               # PipelineResult (numpy arrays)

Detectors: "two_sided" (default; |err - clean median|), "one_sided" (the
paper's "adversarial = high rec error"), "combined" (max of the two-sided
rec-err and low-tail purified-margin ECDF atypicalities), "combined3"
(adds the restart-dispersion feature), "margin" (the margin feature
alone). detect_passes=K averages the detection features of K independent
projection passes (class prediction from pass 0, or the K-pass majority
when vote=True). Calibrate on held-out clean data from the serving
distribution, under the same rec_* settings as serving.

Under a torch.profiler, predict records the spans pipeline.predict (the
call), pipeline.classify (classifier A on a chunk's x_hat), pipeline.sync
(a chunk's one copy to the host and its restart dispersion) and
pipeline.detect (the scores and the threshold), around the chunk spans
of batched_reconstruct (utils/profiling.py::span).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from defensegan_torch.eval.accuracy import batched_reconstruct, to_numpy
from defensegan_torch.eval.detect import (ecdf_atypicality, majority_vote,
                                          multi_feature_scores,
                                          restart_dispersion)
from defensegan_torch.utils.profiling import span

# z0_fn(pass_index, lo) -> z0 [batch, R, k] for an exact replay of draws
Z0Fn = Callable[[int, int], torch.Tensor]


class PipelineResult(NamedTuple):
    pred: np.ndarray        # [N] int32 argmax class on the purified input
    flagged: np.ndarray     # [N] bool detection decision (True = reject)
    rec_err: np.ndarray     # [N] float final projection loss (the statistic)
    margin: np.ndarray      # [N] float purified top1-top2 logit margin
    dispersion: np.ndarray  # [N] float restart-dispersion statistic


class DefendedPipeline:
    """Calibrated purify+classify+detect over a loaded DefenseGAN.

    logits_fn: classifier on [0, 1] NHWC image tensors on gan.device.
    rec_* / rec_kernel / rec_init pass straight to gan.reconstruct.
    """

    def __init__(self, gan, logits_fn: Callable[[torch.Tensor], torch.Tensor],
                 fpr: float = 0.05, detector: str = "two_sided",
                 rec_rr: Optional[int] = None,
                 rec_iters: Optional[int] = None,
                 rec_lr: Optional[float] = None,
                 rec_kernel: Optional[str] = None,
                 rec_init: Optional[str] = None,
                 dispersion_kind: str = "rel_gap",
                 detect_passes: int = 1,
                 vote: bool = False):
        if detector not in ("two_sided", "one_sided", "combined",
                            "combined3", "margin"):
            raise ValueError(f"unknown detector {detector!r}")
        if not 0.0 < fpr < 1.0:
            raise ValueError(f"fpr must be in (0, 1), got {fpr}")
        if detect_passes < 1:
            raise ValueError(f"detect_passes must be >= 1, "
                             f"got {detect_passes}")
        if vote and detect_passes < 2:
            raise ValueError("vote=True needs detect_passes >= 2 "
                             "(majority voting over K projection passes)")
        self.gan = gan
        self.logits_fn = logits_fn
        self.fpr = float(fpr)
        self.detector = detector
        self.dispersion_kind = dispersion_kind
        self.detect_passes = int(detect_passes)
        self.vote = bool(vote)
        self._rec = dict(rec_rr=rec_rr, rec_iters=rec_iters, rec_lr=rec_lr,
                         rec_kernel=rec_kernel, rec_init=rec_init)
        self._center: Optional[float] = None      # clean rec-err median
        self._threshold: Optional[float] = None   # detector score cutoff
        self._errs_calib: Optional[np.ndarray] = None    # combined: ECDFs
        self._margins_calib: Optional[np.ndarray] = None
        self._disp_calib: Optional[np.ndarray] = None    # combined3

    # ------------------------------------------------------------ internals
    @torch.no_grad()
    def _pred(self, x_hat: torch.Tensor):
        logits = self.logits_fn(x_hat)
        top2 = torch.topk(logits, 2, dim=-1).values
        return torch.argmax(logits, dim=-1), top2[:, 0] - top2[:, 1]

    def _scores(self, errs, margins=None, dispersion=None) -> np.ndarray:
        if self.detector in ("combined", "combined3"):
            features = [(errs, self._errs_calib, "two_sided"),
                        (margins, self._margins_calib, "low")]
            if self.detector == "combined3":
                features.append((dispersion, self._disp_calib, "two_sided"))
            return multi_feature_scores(features)
        if self.detector == "margin":
            return ecdf_atypicality(margins, self._margins_calib, "low")
        if self.detector == "two_sided":
            return np.abs(errs - self._center)
        return errs

    def _run_once(self, x, gen, batch_size, z0_fn):
        """One shared projection pass: (preds, rec_errs, margins,
        dispersion)."""
        preds, errs, margins, disps = [], [], [], []
        for res, lo, hi in batched_reconstruct(self.gan, x, gen=gen,
                                               batch_size=batch_size,
                                               z0_fn=z0_fn, **self._rec):
            with span("pipeline.classify"):
                pb, mb = self._pred(res.x_hat)
            k = hi - lo
            with span("pipeline.sync"):
                # one copy to the host a chunk: class, margin, loss and
                # the restarts' losses side by side (float64 holds each
                # exactly)
                host = to_numpy(torch.cat(
                    [pb[:, None].double(), mb[:, None].double(),
                     res.loss[:, None].double(), res.all_losses.double()],
                    dim=1))[:k]
                preds.append(host[:, 0].astype(np.int64))
                margins.append(host[:, 1])
                errs.append(host[:, 2])
                disps.append(restart_dispersion(host[:, 3:],
                                                self.dispersion_kind))
        return (np.concatenate(preds), np.concatenate(errs),
                np.concatenate(margins), np.concatenate(disps))

    def _run(self, x, gen, batch_size, z0_fn: Optional[Z0Fn]):
        """detect_passes projection passes: features averaged, prediction
        from pass 0 (or the majority vote). Passes draw from `gen` in
        turn unless z0_fn replays given draws."""
        outs = []
        for p in range(self.detect_passes):
            fn = None if z0_fn is None else (lambda lo, p=p: z0_fn(p, lo))
            outs.append(self._run_once(x, gen, batch_size, fn))
        if self.detect_passes == 1:
            return outs[0]
        preds = outs[0][0]
        if self.vote:
            preds, _ = majority_vote(np.stack([o[0] for o in outs]))
        return (preds,) + tuple(np.mean([o[i] for o in outs], axis=0)
                                for i in (1, 2, 3))

    def _generator(self, gen, seed: int) -> torch.Generator:
        if gen is not None:
            return gen
        return torch.Generator(device=self.gan.device).manual_seed(seed)

    # ------------------------------------------------------------ public
    def calibrate(self, x_clean, gen: Optional[torch.Generator] = None,
                  batch_size: Optional[int] = None,
                  z0_fn: Optional[Z0Fn] = None) -> "DefendedPipeline":
        """Fit the detection threshold on held-out CLEAN data: the clean
        rec-err median (two-sided center), the ECDF tables of the combined
        detectors, and the (1 - fpr) quantile of the clean scores."""
        _, errs, margins, disps = self._run(x_clean,
                                            self._generator(gen, 0),
                                            batch_size, z0_fn)
        self._center = float(np.median(errs))
        if self.detector in ("combined", "combined3", "margin"):
            self._errs_calib = np.sort(errs)
            self._margins_calib = np.sort(margins)
            if self.detector == "combined3":
                self._disp_calib = np.sort(disps)
        self._threshold = float(np.quantile(
            self._scores(errs, margins, disps), 1.0 - self.fpr))
        return self

    @property
    def calibrated(self) -> bool:
        return self._threshold is not None

    def predict(self, x, gen: Optional[torch.Generator] = None,
                batch_size: Optional[int] = None,
                z0_fn: Optional[Z0Fn] = None) -> PipelineResult:
        """Purify, classify, and flag — one projection pass per input."""
        if not self.calibrated:
            raise RuntimeError("call calibrate(x_clean) before predict() — "
                               "the detector threshold is fit on clean data")
        with span("pipeline.predict"):
            preds, errs, margins, disps = self._run(
                x, self._generator(gen, 1), batch_size, z0_fn)
            with span("pipeline.detect"):
                flagged = self._scores(errs, margins, disps) > \
                    self._threshold
            return PipelineResult(pred=preds.astype(np.int32),
                                  flagged=flagged,
                                  rec_err=errs.astype(np.float32),
                                  margin=margins.astype(np.float32),
                                  dispersion=disps.astype(np.float32))
