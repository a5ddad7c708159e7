"""Image-grid savers (port of the JAX package's utils/visualize.py).

Reference parity: utils/visualize.py of kabkabm/defensegan (the
DCGAN-tensorflow lineage's `merge` / `save_images` / per-image
`save_images_files`). Images are float arrays in [0, 1], NHWC.

The PNG is written with the standard library alone (zlib, struct; the
card's machine has no PIL): 8-bit grey (one channel) or RGB (three), no
interlace, every row under filter 0, the pixels in one IDAT chunk.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

from defensegan_torch.utils.misc import ensure_dir

_COLOR_TYPE = {1: 0, 3: 2}      # channels -> PNG colour type (grey, RGB)


def merge(images: np.ndarray,
          grid: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Tile [N, H, W, C] into one [gh * H, gw * W, C] grid image (row
    major; the default grid is ceil(sqrt(N)) wide)."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    if grid is None:
        gw = int(math.ceil(math.sqrt(n)))
        gh = int(math.ceil(n / gw))
    else:
        gh, gw = grid
    out = np.zeros((gh * h, gw * w, c), dtype=images.dtype)
    for idx in range(min(n, gh * gw)):
        i, j = divmod(idx, gw)
        out[i * h:(i + 1) * h, j * w:(j + 1) * w] = images[idx]
    return out


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, pixels: np.ndarray) -> str:
    """Write uint8 pixels [H, W, C] (C 1 or 3) as a PNG file."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    h, w, c = pixels.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"PNG of {c} channels: grey (1) or RGB (3) only")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           pixels.reshape(h, w * c)], axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         _COLOR_TYPE[c], 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
    return path


def save_images(images: np.ndarray, path: str,
                grid: Optional[Tuple[int, int]] = None) -> str:
    """Save an [N, H, W, C] batch as one PNG grid (reference:
    save_images)."""
    ensure_dir(os.path.dirname(path) or ".")
    return write_png(path, _to_uint8(merge(images, grid)))


def save_images_files(images: np.ndarray, out_dir: str, prefix: str = "img",
                      labels: Optional[Sequence[int]] = None) -> None:
    """Per-image PNG dumps `<prefix>_<i:05d>[_<label>].png` (reference:
    save_images_files)."""
    ensure_dir(out_dir)
    for i, img in enumerate(np.asarray(images)):
        tag = f"_{labels[i]}" if labels is not None else ""
        write_png(os.path.join(out_dir, f"{prefix}_{i:05d}{tag}.png"),
                  _to_uint8(img))
