"""The benchmark's input images: a frozen copy of the port's seeded
stand-in digits (defensegan_torch/data/synthetic.py, smooth style), so
that a change to the program's data code cannot change the benchmark's
inputs.

Class k is a fixed random low-frequency prototype; a sample is its
prototype plus small noise and a random one-pixel shift, clipped to
[0, 1]. Copied as it stood, less the margin control and the sparse style
that no cell uses; `data_seed` folds any --seed into the range that
numpy's RandomState takes after the generator's own arithmetic.
"""

from __future__ import annotations

import numpy as np

SPLIT_SALT = {"train": 0, "dev": 1, "test": 2}


def data_seed(seed: int) -> int:
    """A seed for make_synthetic: seed * 104729 + 2 * 7907 + 23 must stay
    below 2**32."""
    return int(seed) % 40000


def _smooth(img: np.ndarray, iters: int = 2) -> np.ndarray:
    """Cheap box blur to give prototypes digit-like low-frequency
    structure."""
    for _ in range(iters):
        p = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
        img = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
               + p[1:-1, 1:-1]) / 5.0
    return img


def _build_protos(rng: np.random.RandomState, image_size: int,
                  channels: int, num_classes: int) -> np.ndarray:
    protos = []
    for _ in range(num_classes):
        p = rng.rand(image_size, image_size, channels).astype(np.float32)
        p = _smooth(p, iters=3)
        # stretch contrast so prototypes are well separated
        p = (p - p.min()) / max(p.max() - p.min(), 1e-6)
        protos.append(p)
    return np.stack(protos)  # [K, H, W, C]


def make_synthetic(num: int, image_size: int, channels: int,
                   num_classes: int = 10, seed: int = 0,
                   split: str = "test"):
    """Return (images [N,H,W,C] float32 in [0,1], labels [N] int32)."""
    rng = np.random.RandomState(seed * 7919 + 17)
    protos = _build_protos(rng, image_size, channels, num_classes)
    srng = np.random.RandomState(seed * 104729 + SPLIT_SALT[split] * 7907
                                 + 23)
    labels = srng.randint(0, num_classes, size=num).astype(np.int32)
    images = protos[labels].copy()
    # per-sample jitter: noise + random 1-pixel shift
    noise = srng.randn(*images.shape).astype(np.float32) * 0.08
    images = images + noise
    shifts = srng.randint(-1, 2, size=(num, 2))
    for i, (dy, dx) in enumerate(shifts):
        images[i] = np.roll(images[i], (dy, dx), axis=(0, 1))
    return np.clip(images, 0.0, 1.0), labels
