"""Deterministic synthetic image datasets (offline stand-ins; the port's
own copy of the JAX package's data/synthetic.py, array for array).

Not in the reference (it downloads real data; datasets/utils.py). Used here so
training / defense / attack pipelines run end-to-end with zero network access:
class k is a fixed random low-frequency prototype; samples are the prototype
plus small jitter and random shifts. Learnable by both the classifiers and the
WGAN, and fully deterministic given the seed.

`margin` (round-3 addition, VERDICT round-2 item 1): optional control of the
minimum inter-class L2 distance between prototypes in flattened [0,1] pixel
space — the variable the FGSM-defended-accuracy gap hypothesis turns on
(an eps=0.3 L-inf ball has L2 radius up to 0.3*sqrt(HWC) ~ 8.4 at 28x28, so
whether projection lands on the right class manifold depends on this margin).
scripts/margin_experiment.py sweeps it with everything else fixed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _smooth(img: np.ndarray, iters: int = 2) -> np.ndarray:
    """Cheap box blur to give prototypes digit-like low-frequency structure."""
    for _ in range(iters):
        p = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
        img = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
               + p[1:-1, 1:-1]) / 5.0
    return img


def min_pairwise_l2(protos: np.ndarray) -> float:
    """Minimum inter-class L2 distance over flattened prototypes [K,...]."""
    flat = protos.reshape(len(protos), -1).astype(np.float64)
    d2 = ((flat[:, None] - flat[None]) ** 2).sum(-1)
    iu = np.triu_indices(len(protos), 1)
    return float(np.sqrt(d2[iu].min()))


def _build_protos(rng: np.random.RandomState, image_size: int,
                  channels: int, num_classes: int,
                  margin: Optional[float] = None,
                  style: str = "smooth") -> np.ndarray:
    protos = []
    for _ in range(num_classes):
        p = rng.rand(image_size, image_size, channels).astype(np.float32)
        p = _smooth(p, iters=3)
        # stretch contrast so prototypes are well separated
        p = (p - p.min()) / max(p.max() - p.min(), 1e-6)
        if style == "sparse":
            # MNIST-like support statistics: mostly-zero background with
            # bright strokes (~20% active pixels). Background zeros matter
            # for adversarial robustness: the [0,1] clip discards the
            # negative half of an L-inf perturbation there, and the image
            # manifold is locally orthogonal to background directions.
            thresh = np.quantile(p, 0.8)
            p = np.where(p > thresh, (p - thresh) / max(1 - thresh, 1e-6),
                         0.0).astype(np.float32)
            p = np.clip(p * 2.5, 0.0, 1.0)  # bright strokes like MNIST
        elif style != "smooth":
            raise ValueError(f"unknown style {style!r}")
        protos.append(p)
    protos = np.stack(protos)  # [K, H, W, C]
    if margin is not None:
        # rescale deviations around the class-mean image until the minimum
        # pairwise distance hits the target; clipping to [0,1] shrinks the
        # achieved margin, so iterate the (scale, clip) map to its fixed
        # point — it saturates at the max margin [0,1]^d admits for these
        # patterns. Callers read the ACHIEVED margin via min_pairwise_l2.
        center = protos.mean(axis=0, keepdims=True)
        for _ in range(12):
            cur = min_pairwise_l2(protos)
            if abs(cur - margin) <= 0.005 * margin:
                break
            protos = np.clip(
                center + (protos - center) * (margin / max(cur, 1e-6)),
                0.0, 1.0)
    return protos


def synthetic_protos(image_size: int, channels: int, num_classes: int = 10,
                     seed: int = 0, margin: Optional[float] = None,
                     style: str = "smooth") -> np.ndarray:
    """The class prototypes make_synthetic draws from (for margin probes)."""
    rng = np.random.RandomState(seed * 7919 + 17)
    return _build_protos(rng, image_size, channels, num_classes, margin,
                         style)


def make_synthetic(num: int, image_size: int, channels: int,
                   num_classes: int = 10, seed: int = 0,
                   split: str = "train", margin: Optional[float] = None,
                   style: str = "smooth"):
    """Return (images [N,H,W,C] float32 in [0,1], labels [N] int32)."""
    split_salt = {"train": 0, "dev": 1, "val": 1, "test": 2}.get(split, 3)
    rng = np.random.RandomState(seed * 7919 + 17)
    protos = _build_protos(rng, image_size, channels, num_classes, margin,
                           style)

    srng = np.random.RandomState(seed * 104729 + split_salt * 7907 + 23)
    labels = srng.randint(0, num_classes, size=num).astype(np.int32)
    images = protos[labels].copy()
    # per-sample jitter: noise + random 1-pixel shift
    noise = srng.randn(*images.shape).astype(np.float32) * 0.08
    images = images + noise
    shifts = srng.randint(-1, 2, size=(num, 2))
    for i, (dy, dx) in enumerate(shifts):
        images[i] = np.roll(images[i], (dy, dx), axis=(0, 1))
    return np.clip(images, 0.0, 1.0), labels
