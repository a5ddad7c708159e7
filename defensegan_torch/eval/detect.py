"""Adversarial-input detection by reconstruction error (port of the JAX
package's eval/detect.py; the numpy functions are the port's own copies).

The Defense-GAN paper's detector (Samangouei et al., ICLR 2018, section
5.1) thresholds the final projection loss; the two-feature detector also
scores the purified classifier margin, and the pipeline the restart
dispersion. The features come from the same batched projection the
defense runs (gan.reconstruct: a fused kernel on CUDA); the ROC and AUC
arithmetic is a few thousand floats on the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from defensegan_torch.eval.accuracy import batched_reconstruct, to_numpy


class DetectionFeatures(NamedTuple):
    """Per-image detection features from one shared projection pass.

    errs:       [N] final best-restart projection loss (tanh-space MSE)
    margins:    [N] purified classifier top1-top2 logit margin on G(z*)
    all_losses: [N, R] final loss of every restart
    preds:      [N] purified classifier argmax on G(z*)
    """

    errs: np.ndarray
    margins: np.ndarray
    all_losses: np.ndarray
    preds: np.ndarray


def reconstruction_errors(gan, x, gen: Optional[torch.Generator] = None,
                          batch_size: Optional[int] = None,
                          rec_rr: Optional[int] = None,
                          rec_iters: Optional[int] = None,
                          rec_lr: Optional[float] = None,
                          rec_kernel: Optional[str] = None,
                          rec_init: Optional[str] = None,
                          z0_fn: Optional[Callable[[int], torch.Tensor]]
                          = None) -> np.ndarray:
    """Per-image final projection loss (tanh-space MSE), shape [N].

    Batching, padding, draws and overrides are model_eval_gan's: both ride
    eval/accuracy.py::batched_reconstruct.
    """
    out = []
    with torch.no_grad():
        for res, lo, hi in batched_reconstruct(
                gan, x, gen=gen, batch_size=batch_size, rec_rr=rec_rr,
                rec_iters=rec_iters, rec_lr=rec_lr, rec_kernel=rec_kernel,
                rec_init=rec_init, z0_fn=z0_fn):
            out.append(to_numpy(res.loss)[:hi - lo])
    return np.concatenate(out)


def detection_features(gan, x, logits_fn: Callable[[torch.Tensor],
                                                   torch.Tensor],
                       gen: Optional[torch.Generator] = None,
                       batch_size: Optional[int] = None,
                       rec_rr: Optional[int] = None,
                       rec_iters: Optional[int] = None,
                       rec_lr: Optional[float] = None,
                       rec_kernel: Optional[str] = None,
                       rec_init: Optional[str] = None,
                       z0_fn: Optional[Callable[[int], torch.Tensor]] = None,
                       ) -> DetectionFeatures:
    """One shared projection pass -> DetectionFeatures(errs, margins,
    all_losses, preds): the final projection loss (the paper's section
    5.1 statistic) and the purified classifier's top1 - top2 logit margin
    on G(z*), both label-free, plus every restart's final loss and the
    purified prediction. Two calls with generators seeded alike draw the
    same z0 per batch position: a clean and an adversarial pass so seeded
    are paired."""
    errs, margins, alll, preds = [], [], [], []
    with torch.no_grad():
        for res, lo, hi in batched_reconstruct(
                gan, x, gen=gen, batch_size=batch_size, rec_rr=rec_rr,
                rec_iters=rec_iters, rec_lr=rec_lr, rec_kernel=rec_kernel,
                rec_init=rec_init, z0_fn=z0_fn):
            k = hi - lo
            logits = logits_fn(res.x_hat[:k])
            top2 = torch.topk(logits, 2, dim=-1).values
            errs.append(to_numpy(res.loss)[:k])
            margins.append(to_numpy(top2[:, 0] - top2[:, 1]))
            alll.append(to_numpy(res.all_losses)[:k])
            preds.append(to_numpy(torch.argmax(logits, dim=-1), np.int32))
    return DetectionFeatures(np.concatenate(errs), np.concatenate(margins),
                             np.concatenate(alll), np.concatenate(preds))


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


def combined_scores(errs: np.ndarray, margins: np.ndarray,
                    errs_calib: np.ndarray, margins_calib: np.ndarray
                    ) -> np.ndarray:
    """Two-feature detection statistic: max of per-feature atypicality.

    max(two-sided rec-err score, low-tail purified-margin score) — an
    input is flagged if EITHER feature is atypical vs clean calibration.
    """
    return multi_feature_scores([(errs, errs_calib, "two_sided"),
                                 (margins, margins_calib, "low")])


def roc_auc(scores_neg: np.ndarray, scores_pos: np.ndarray) -> float:
    """Area under the ROC for `score > threshold => positive`.

    Rank-based (Mann-Whitney U) with average ranks for ties — exact, no
    threshold grid, no sklearn. 0.5 = chance, 1.0 = perfect separation.
    """
    neg = np.asarray(scores_neg, np.float64)
    pos = np.asarray(scores_pos, np.float64)
    if neg.size == 0 or pos.size == 0:
        raise ValueError("roc_auc needs both negative and positive scores")
    combined = np.concatenate([neg, pos])
    order = np.argsort(combined, kind="mergesort")
    ranks = np.empty_like(combined)
    ranks[order] = np.arange(1, combined.size + 1, dtype=np.float64)
    # average ranks over tied values
    sorted_vals = combined[order]
    i = 0
    while i < sorted_vals.size:
        j = i
        while j + 1 < sorted_vals.size and sorted_vals[j + 1] == sorted_vals[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    u = ranks[neg.size:].sum() - pos.size * (pos.size + 1) / 2.0
    return float(u / (neg.size * pos.size))


def roc_points(scores_neg: np.ndarray, scores_pos: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) sweeping the threshold over every score."""
    neg = np.asarray(scores_neg, np.float64)
    pos = np.asarray(scores_pos, np.float64)
    thresholds = np.unique(np.concatenate([neg, pos]))[::-1]
    fpr = np.array([(neg > t).mean() for t in thresholds])
    tpr = np.array([(pos > t).mean() for t in thresholds])
    return fpr, tpr, thresholds


def tpr_at_fpr(scores_neg: np.ndarray, scores_pos: np.ndarray,
               max_fpr: float = 0.05) -> Tuple[float, float]:
    """(detection rate, threshold) at the largest FPR <= max_fpr."""
    fpr, tpr, thr = roc_points(scores_neg, scores_pos)
    ok = fpr <= max_fpr
    if not ok.any():
        return 0.0, float("inf")
    i = int(np.argmax(tpr[ok]))
    return float(tpr[ok][i]), float(thr[ok][i])


def two_sided_scores(errs: np.ndarray, clean_errs: np.ndarray) -> np.ndarray:
    """Two-sided detection statistic: |rec_err - median(clean rec_err)|.

    The one-sided detector ("adversarial = HIGH rec error", paper section
    5.1) is blind to detection-aware attacks that spend their budget
    pushing inputs ONTO the manifold: a PGD with a rec-error penalty
    (whitebox --pgd_rec_penalty, queue S) produces rec errors BELOW the
    clean distribution (flagship: 0.00026 adv vs 0.033 clean median) —
    one-sided AUC goes to 0 while the examples remain wildly atypical.
    Distance from the clean median catches both tails; the operator
    calibrates on clean data only (median is a clean-distribution
    statistic, available at deployment).
    """
    center = float(np.median(np.asarray(clean_errs, np.float64)))
    return np.abs(np.asarray(errs, np.float64) - center)


def bootstrap_auc_ci(scores_neg: np.ndarray, scores_pos: np.ndarray,
                     n_boot: int = 1000, alpha: float = 0.05,
                     seed: int = 0) -> Tuple[float, float]:
    """Percentile-bootstrap (1-alpha) CI for roc_auc.

    Resamples both classes with replacement; answers "is AUC 0.83 on 256
    examples actually different from 0.75?" for the RESULTS tables. Pure
    host numpy — thousands of floats, no device work.
    """
    rng = np.random.default_rng(seed)
    neg = np.asarray(scores_neg, np.float64)
    pos = np.asarray(scores_pos, np.float64)
    aucs = [roc_auc(rng.choice(neg, neg.size, replace=True),
                    rng.choice(pos, pos.size, replace=True))
            for _ in range(n_boot)]
    lo, hi = np.quantile(aucs, [alpha / 2.0, 1.0 - alpha / 2.0])
    return float(lo), float(hi)


def calibration_sweep(errs_clean: np.ndarray, errs_adv: np.ndarray,
                      detector: str = "two_sided", fpr: float = 0.05,
                      sizes: Tuple[int, ...] = (16, 32, 64, 128),
                      trials: int = 200, seed: int = 0,
                      margins_clean: Optional[np.ndarray] = None,
                      margins_adv: Optional[np.ndarray] = None) -> list:
    """How many clean samples does the detector threshold need?

    The operational question behind DefendedPipeline.calibrate(): the
    operator fits center+threshold on a finite clean sample; a small one
    mis-places the (1-fpr) quantile and the realized FPR/TPR drift. Per
    calibration size n: subsample n clean errors WITHOUT replacement,
    fit the detector exactly as the pipeline does (two-sided center =
    calib median; threshold = (1-fpr) quantile of calib scores), then
    measure the realized FPR on the held-out clean remainder and TPR on
    the adversarial errors. Returns one dict per size with mean/p90
    realized FPR and mean/std TPR over `trials` resamples.

    detector="combined" additionally needs margins_clean/margins_adv
    (paired with the errs arrays): per trial the clean calibration split
    provides BOTH ECDF tables, so the sweep answers whether two
    nonparametric tables need more clean data than one quantile.
    """
    if detector not in ("two_sided", "one_sided", "combined"):
        raise ValueError(f"unknown detector {detector!r}")
    if detector == "combined" and (margins_clean is None
                                   or margins_adv is None):
        raise ValueError("detector='combined' needs margins_clean and "
                         "margins_adv paired with the errs arrays")
    rng = np.random.default_rng(seed)
    clean = np.asarray(errs_clean, np.float64)
    adv = np.asarray(errs_adv, np.float64)
    if detector == "combined":
        m_clean = np.asarray(margins_clean, np.float64)
        m_adv = np.asarray(margins_adv, np.float64)
        if m_clean.shape != clean.shape or m_adv.shape != adv.shape:
            raise ValueError("margins must pair 1:1 with errs")
    rows = []
    for n in sizes:
        if n >= clean.size:
            raise ValueError(f"calibration size {n} needs held-out clean "
                             f"data (have {clean.size} clean errors)")
        fprs, tprs = [], []
        for _ in range(trials):
            idx = rng.permutation(clean.size)
            calib, held = clean[idx[:n]], clean[idx[n:]]
            if detector == "combined":
                mc, mh = m_clean[idx[:n]], m_clean[idx[n:]]
                s_cal = combined_scores(calib, mc, calib, mc)
                s_held = combined_scores(held, mh, calib, mc)
                s_adv = combined_scores(adv, m_adv, calib, mc)
            elif detector == "two_sided":
                center = float(np.median(calib))
                s_cal = np.abs(calib - center)
                s_held = np.abs(held - center)
                s_adv = np.abs(adv - center)
            else:
                s_cal, s_held, s_adv = calib, held, adv
            thr = np.quantile(s_cal, 1.0 - fpr)
            fprs.append(float((s_held > thr).mean()))
            tprs.append(float((s_adv > thr).mean()))
        rows.append({
            "calib_n": int(n), "detector": detector,
            "fpr_target": float(fpr), "trials": int(trials),
            "fpr_mean": float(np.mean(fprs)),
            "fpr_p90": float(np.quantile(fprs, 0.9)),
            "tpr_mean": float(np.mean(tprs)),
            "tpr_std": float(np.std(tprs)),
        })
    return rows


def undetected_success_rate(scores_clean: np.ndarray,
                            scores_adv: np.ndarray,
                            misclassified_adv: np.ndarray,
                            max_fpr: float = 0.05) -> Tuple[float, float]:
    """(joint rate, threshold): P(adv misclassified AND not detected).

    The single number that says whether one attack beats BOTH defense
    layers: threshold the detection scores at max_fpr on the clean set
    (what an operator can calibrate), flag adv examples above it, and
    count the fraction that are simultaneously misclassified by the
    defended pipeline AND unflagged. 0.0 = the two layers jointly stop
    every attack instance; an attacker tuning lambda (queue S) maximizes
    this quantity.

    Pass semantics: in the whitebox/blackbox CLIs the misclassification
    flags come from the defended-eval projection pass while the scores
    come from the detect pass (which keeps clean-vs-adv PAIRED on one
    key) — a cross-pass estimate over the defense's restart randomness.
    defense/pipeline.py::DefendedPipeline measures the single-shared-pass
    joint rate an actual deployment sees (one projection serves both
    layers). The two agree in expectation but are not the same sample.
    """
    scores_adv = np.asarray(scores_adv, np.float64)
    mis = np.asarray(misclassified_adv, bool)
    if scores_adv.shape != mis.shape:
        raise ValueError("scores_adv and misclassified_adv must align "
                         f"({scores_adv.shape} vs {mis.shape})")
    thr = np.quantile(np.asarray(scores_clean, np.float64), 1.0 - max_fpr)
    undetected = scores_adv <= thr
    return float((mis & undetected).mean()), float(thr)
