"""Tables and padding of the 3x3 SAME grid convs (taps k = (dy+1)*3 +
(dx+1), pixel offset dy*g + dx), shared by v3, v4, kernels/conv3x3.py and
the v3 layout experiments."""

import numpy as np
import torch
import torch.nn.functional as F


def tap_offsets(g: int):
    """Pixel offsets of a 3x3 SAME conv, index k = (dy+1)*3 + (dx+1)."""
    return [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def tap_masks(g: int) -> np.ndarray:
    """[g*g, 9] validity of reading pixel p + off_k (inside the grid)."""
    m = np.zeros((g * g, 9), np.float32)
    for p in range(g * g):
        y, x = divmod(p, g)
        for k, (dy, dx) in enumerate(tap_offsets(g)):
            m[p, k] = float(0 <= y + dy < g and 0 <= x + dx < g)
    return m


def pixel_order(g: int) -> np.ndarray:
    """[g*g] int32: the grid's pixels by their count of valid taps, most
    first (9 inside, 6 on an edge, 4 in a corner), in pixel order within a
    count. The grid conv (csrc/conv3x3_sm90.cuh) walks each 128-row slice
    of the activation in this order, so the cheapest tiles come last."""
    return np.argsort(-tap_masks(g).sum(1), kind="stable").astype(np.int32)


def pad_blocks(t: torch.Tensor, view, target) -> torch.Tensor:
    """View t as `view`, zero-pad every axis up to `target`; t itself
    where nothing is to pad."""
    if tuple(view) == tuple(target):
        return t
    pads = []
    for have, want in zip(reversed(view), reversed(target)):
        pads += [0, want - have]
    return F.pad(t.reshape(view), pads)


def bf16_round(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float()
