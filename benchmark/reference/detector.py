"""The two-sided reconstruction-error detector (Defense-GAN, section 5.1,
with the rule |err - clean median| > the clean (1 - fpr) quantile of that
distance), in numpy float64."""

from __future__ import annotations

import numpy as np


def calibrate(clean_errs: np.ndarray, fpr: float):
    """(center, threshold) from the clean set's final projection losses:
    the median, and the (1 - fpr) quantile (linear interpolation) of the
    distance to it."""
    errs = np.asarray(clean_errs, np.float64)
    center = float(np.median(errs))
    threshold = float(np.quantile(np.abs(errs - center), 1.0 - fpr))
    return center, threshold


def scores(errs: np.ndarray, center: float) -> np.ndarray:
    return np.abs(np.asarray(errs, np.float64) - center)
