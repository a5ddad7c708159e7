"""Kernel-quality metrics for alternative projection paths (the port's own
copy of the JAX package's eval/quality.py; plain numpy).

Used to gate a kernel's restart selection against a reference path: raw
argmin agreement under-reports quality because restarts whose final
losses tie within bf16 noise are interchangeable. The tie-aware metric
charges a disagreement only when the chosen restart is MATERIALLY worse
under the reference losses.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# The bf16-vs-f32 final-loss jitter between equal-quality restarts of the
# flagship, as the JAX package measured it; gaps below this are ties, not
# quality differences.
BF16_TIE_TAU = 2e-3


def tie_aware_disagreement(ref_losses: np.ndarray,
                           test_losses: np.ndarray,
                           tau: float = BF16_TIE_TAU) -> Dict[str, float]:
    """Compare restart selections of a test path against a reference path.

    ref_losses, test_losses: [B, R] final per-restart losses of the SAME
    (x, z0) draws under the reference (f32/XLA) and test (e.g. int8)
    paths. The test path's pick for image i is test_losses[i].argmin();
    its quality is judged under the REFERENCE losses: regret_i =
    ref[i, test_pick] - ref[i].min().

    Returns:
      raw_disagreement:      fraction of images where the argmins differ
                             (the old metric — counts harmless ties)
      material_disagreement: fraction where regret > tau (real quality
                             loss beyond bf16 noise)
      mean_regret, max_regret: regret stats in loss units
      tau: the tie threshold used
    """
    ref = np.asarray(ref_losses, np.float64)
    test = np.asarray(test_losses, np.float64)
    if ref.shape != test.shape or ref.ndim != 2:
        raise ValueError(f"need matching [B, R] losses, got {ref.shape} "
                         f"vs {test.shape}")
    idx = np.arange(ref.shape[0])
    pick_t = test.argmin(1)
    pick_r = ref.argmin(1)
    regret = ref[idx, pick_t] - ref[idx, pick_r]
    return {
        "raw_disagreement": float((pick_t != pick_r).mean()),
        "material_disagreement": float((regret > tau).mean()),
        "mean_regret": float(regret.mean()),
        "max_regret": float(regret.max()),
        "tau": float(tau),
    }


def best_loss_p95(ref_losses: np.ndarray, test_losses: np.ndarray) -> float:
    """p95 over images of |best test loss - best reference loss|."""
    ref = np.asarray(ref_losses, np.float64).min(1)
    test = np.asarray(test_losses, np.float64).min(1)
    return float(np.quantile(np.abs(test - ref), 0.95))


def int8_gate_ok(mat8: float, mat16: float, p95_int8: float,
                 p95_bf16: float) -> bool:
    """The int8 promotion criterion of output/gans/<run>/checkpoints/
    int8_gate.json, control-relative on both axes: int8's material
    disagreement vs the reference may not exceed max(0.03, the bf16
    control's + 0.005), and its best-loss p95 delta may not exceed
    max(1e-3, 2x the bf16 control's)."""
    return (mat8 <= max(0.03, mat16 + 0.005)
            and p95_int8 <= max(1e-3, 2.0 * p95_bf16))
