"""Random-audit serving: serve at a cheap operating point, audit a random
subset at the security configuration (port of the JAX package's
defense/audit.py).

The cascade: every input is served at the cheap point (e.g.
rec_init=encoder, R=2, L=50), and independently a random p-fraction is
re-run through the full-budget pipeline (R=10, L=200). An attacker who
tailors to the cheap config is exposed to the expensive config's detector
on every audited query. Expected undetected success per query:

    (1 - p) * leak_serve(attack) + p * leak_audit(attack)

at a cost of serve + p * audit per input instead of the full budget on
every input. It composes two DefendedPipeline objects
(defense/pipeline.py).

Usage:
    serve = DefendedPipeline(gan, logits_fn, detector="combined",
                             rec_rr=2, rec_iters=50, rec_init="encoder")
    audit = DefendedPipeline(gan, logits_fn, detector="combined")
    pipe = AuditedPipeline(serve, audit, audit_prob=0.1)
    pipe.calibrate(x_clean_heldout)        # calibrates BOTH pipelines
    out = pipe.predict(x, gen)
    out.pred      # audit-config prediction on audited rows, serve's else
    out.flagged   # serve flag OR (audited AND audit flag)
    out.audited   # [N] bool — which rows took the expensive pass
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from defensegan_torch.defense.pipeline import (DefendedPipeline,
                                               PipelineResult, Z0Fn)


class AuditResult(NamedTuple):
    pred: np.ndarray        # [N] int32 (audit pred where audited)
    flagged: np.ndarray     # [N] bool (serve OR audit flag)
    audited: np.ndarray     # [N] bool audit-selection mask
    serve: PipelineResult   # the cheap pass on all N inputs
    audit: Optional[PipelineResult]  # the expensive pass on the subset


class AuditedPipeline:
    """Cheap-serve / random-expensive-audit cascade over two calibrated
    DefendedPipelines.

    serve / audit: DefendedPipeline instances (typically the same gan +
    logits_fn at different rec_rr/rec_iters/rec_init operating points;
    nothing requires that — detector choice may differ too).
    audit_prob: per-image probability of the expensive pass, in (0, 1].

    Audited rows report the AUDIT config's class prediction (the security
    configuration of record) and are flagged if EITHER detector fires.
    Selection is a deterministic function of `seed` and of the number of
    predict() calls made so far (a CPU torch.Generator owned by the
    pipeline draws it), so a fresh pipeline with the same seed reproduces
    the run; `audited` in predict() overrides the draw.
    """

    def __init__(self, serve: DefendedPipeline, audit: DefendedPipeline,
                 audit_prob: float = 0.1, seed: int = 0xA0D17):
        if not 0.0 < audit_prob <= 1.0:
            raise ValueError(f"audit_prob must be in (0, 1], "
                             f"got {audit_prob}")
        self.serve = serve
        self.audit = audit
        self.audit_prob = float(audit_prob)
        self._select = torch.Generator().manual_seed(seed)

    # ------------------------------------------------------------ public
    def calibrate(self, x_clean, gen: Optional[torch.Generator] = None,
                  batch_size: Optional[int] = None,
                  serve_z0_fn: Optional[Z0Fn] = None,
                  audit_z0_fn: Optional[Z0Fn] = None) -> "AuditedPipeline":
        """Calibrate both pipelines on the same held-out clean data.

        Each pipeline fits its own clean feature ECDFs/threshold under its
        own projection configuration. With `gen`, the serve pipeline draws
        from it first and the audit pipeline after; the z0_fn arguments
        replay given draws instead (DefendedPipeline.calibrate)."""
        self.serve.calibrate(x_clean, gen, batch_size, serve_z0_fn)
        self.audit.calibrate(x_clean, gen, batch_size, audit_z0_fn)
        return self

    @property
    def calibrated(self) -> bool:
        return self.serve.calibrated and self.audit.calibrated

    def select(self, n: int) -> np.ndarray:
        """The next audit-selection mask, [n] bool, Bernoulli(audit_prob)
        per image from the pipeline's seeded generator."""
        u = torch.rand(n, generator=self._select)
        return (u < self.audit_prob).numpy()

    def predict(self, x, gen: Optional[torch.Generator] = None,
                batch_size: Optional[int] = None,
                audited: Optional[np.ndarray] = None,
                serve_z0_fn: Optional[Z0Fn] = None,
                audit_z0_fn: Optional[Z0Fn] = None) -> AuditResult:
        """Cheap pass on everything; expensive pass on a random subset
        (or on the rows of the given `audited` mask)."""
        if not self.calibrated:
            raise RuntimeError("call calibrate(x_clean) before predict()")
        n = x.shape[0]
        out = self.serve.predict(x, gen, batch_size, serve_z0_fn)
        if audited is None:
            audited = self.select(n)
        audited = np.asarray(audited, bool)
        if audited.shape != (n,):
            raise ValueError(f"audited mask {audited.shape} vs {n} inputs")
        pred = out.pred.copy()
        flagged = out.flagged.copy()
        audit_out = None
        if audited.any():
            rows = torch.as_tensor(np.flatnonzero(audited))
            x_sub = x[rows.to(x.device)] if torch.is_tensor(x) \
                else np.asarray(x)[audited]
            audit_out = self.audit.predict(x_sub, gen, batch_size,
                                           audit_z0_fn)
            pred[audited] = audit_out.pred
            flagged[audited] |= audit_out.flagged
        return AuditResult(pred=pred, flagged=flagged, audited=audited,
                           serve=out, audit=audit_out)
