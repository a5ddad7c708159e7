"""Detection helpers of the defended pipeline (the port's own copies of the
numpy functions in the JAX package's eval/detect.py).

The Defense-GAN paper's detector (Samangouei et al., ICLR 2018, section
5.1) thresholds the final projection loss; the pipeline also scores the
purified classifier margin and the restart dispersion. All of it is a few
thousand floats on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def ecdf_atypicality(vals: np.ndarray, calib: np.ndarray,
                     side: str = "two_sided") -> np.ndarray:
    """Nonparametric per-feature detection score in [0, 1].

    u = midrank empirical CDF of each value under the CLEAN calibration
    sample; the score is how far into a suspicious tail the value sits:
    side="two_sided" -> 2*|u - 0.5| (either tail is atypical, the
    rec-err convention), "low" -> 1 - u (small values suspicious, the
    margin convention), "high" -> u. Distribution-free: thresholding the
    score at (1 - fpr) realizes ~fpr on clean data by construction,
    which is what makes features on different scales (tanh-space MSE vs
    logit units) combinable without tuning.
    """
    if side not in ("two_sided", "low", "high"):
        raise ValueError(f"unknown side {side!r}")
    calib = np.sort(np.asarray(calib, np.float64))
    v = np.asarray(vals, np.float64)
    # midrank ECDF: (#calib < v + #calib <= v) / (2n) — ties get half mass
    lo = np.searchsorted(calib, v, side="left")
    hi = np.searchsorted(calib, v, side="right")
    u = (lo + hi) / (2.0 * calib.size)
    if side == "two_sided":
        return 2.0 * np.abs(u - 0.5)
    return 1.0 - u if side == "low" else u


def majority_vote(preds_pp: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Majority vote over the pass axis. preds_pp: [K, N] int predictions.

    Returns (vote [N], disagreement [N]); disagreement = 1 - top-vote
    share (0 when all K passes agree). Ties break toward pass 0, so
    K=1 voting reproduces the single-pass prediction exactly and a
    K-pass deployment's tie fallback is its pass-0 answer.
    """
    P = np.asarray(preds_pp)
    if P.ndim != 2:
        raise ValueError(f"preds_pp must be [K, N], got {P.shape}")
    k, n = P.shape
    n_cls = int(P.max()) + 1 if P.size else 1
    counts = np.zeros((n, n_cls), np.int64)
    for row in P:
        counts[np.arange(n), row] += 1
    top = counts.max(axis=1)
    maj = counts.argmax(axis=1)
    tie_with_first = counts[np.arange(n), P[0]] == top
    maj = np.where(tie_with_first, P[0], maj)
    return maj.astype(P.dtype), 1.0 - top / float(k)


def multi_feature_scores(features) -> np.ndarray:
    """N-feature detection statistic: max of per-feature atypicality.

    features: sequence of (vals [N], calib [M], side) triples, each
    scored by ecdf_atypicality. max (not sum) keeps the per-feature
    semantics: a clean input needs EVERY feature typical, which grows
    the clean tail mass roughly linearly in the feature count at a given
    per-feature threshold — the (1 - fpr) quantile of the max score on
    clean calibration absorbs that automatically. Where one feature is
    strong and the others uninformative, the max dilutes the strong one's
    AUC: adding features is only free at the flag/no-flag threshold.
    """
    scores = [ecdf_atypicality(v, c, side) for v, c, side in features]
    return np.maximum.reduce(scores)


def restart_dispersion(all_losses: np.ndarray, kind: str = "rel_gap"
                       ) -> np.ndarray:
    """Per-image dispersion of the R restart final losses — the
    candidate THIRD detection feature (free: defense/project.py returns
    all_losses [B, R] with every reconstruction).

    Rationale: the projection runs R independent z0 basins per image;
    the detector scores only the WINNER's loss. A detection-aware
    attacker (centered SPSA/PGD) sculpts the input so the winning loss
    lands on the clean median — but the R-1 losing basins are not
    directly optimized, so their spread relative to the winner is a
    side channel the attacker does not control. Scored two-sided vs
    clean calibration (either unusually tight or unusually wide is
    atypical).

    kinds (all scale-normalized by the winner so the statistic is
    comparable across the clean rec-err range):
      rel_gap: (mean - min) / (min + eps) — mean regret of the losers
      rel_spread: (max - min) / (min + eps)
      cv: std / (mean + eps) — plain coefficient of variation
    """
    al = np.asarray(all_losses, np.float64)
    if al.ndim != 2:
        raise ValueError(f"all_losses must be [N, R], got {al.shape}")
    eps = 1e-12
    mn = al.min(axis=1)
    if kind == "rel_gap":
        return (al.mean(axis=1) - mn) / (mn + eps)
    if kind == "rel_spread":
        return (al.max(axis=1) - mn) / (mn + eps)
    if kind == "cv":
        return al.std(axis=1) / (al.mean(axis=1) + eps)
    raise ValueError(f"unknown dispersion kind {kind!r}")
