"""The port's image-grid savers (defensegan_torch/utils/visualize.py: a
PNG writer on zlib and struct alone) against the JAX package's
utils/visualize.py (PIL): grids of grey and RGB batches, square and not,
with the default and an explicit grid, and the per-image dumps, decoded
with PIL and compared pixel for pixel (exactly equal)."""

import os
import zlib

import numpy as np
import pytest
from PIL import Image

from defensegan_tpu.utils import visualize as jax_vis
from defensegan_torch.utils import visualize as port_vis


def _png(path):
    with Image.open(path) as im:
        im.load()
        return im.mode, np.asarray(im)


@pytest.mark.parametrize("n,c,grid", [(16, 1, None), (5, 1, None),
                                      (6, 3, None), (8, 1, (4, 2)),
                                      (7, 3, (3, 3))])
def test_save_images_matches_jax_pixel_for_pixel(tmp_path, n, c, grid):
    rng = np.random.RandomState(n * 10 + c)
    # values outside [0, 1] are clipped; the rounding half-way points too
    x = rng.uniform(-0.2, 1.2, (n, 9, 7, c)).astype(np.float32)
    x[0, 0, 0] = 0.5 / 255.0
    np.testing.assert_array_equal(port_vis.merge(x, grid),
                                  jax_vis.merge(x, grid))
    a = port_vis.save_images(x, str(tmp_path / "port" / "g.png"), grid)
    b = jax_vis.save_images(x, str(tmp_path / "jax" / "g.png"), grid)
    mode_a, px_a = _png(a)
    mode_b, px_b = _png(b)
    assert mode_a == mode_b == ("L" if c == 1 else "RGB")
    np.testing.assert_array_equal(px_a, px_b)
    # a well-formed PNG: signature, IHDR first, one IDAT, IEND last
    raw = open(a, "rb").read()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n" and raw[12:16] == b"IHDR"
    assert raw.count(b"IDAT") == 1 and raw.endswith(
        b"IEND" + zlib.crc32(b"IEND").to_bytes(4, "big"))


def test_save_images_files_matches_jax(tmp_path):
    x = np.random.RandomState(1).rand(3, 8, 8, 1).astype(np.float32)
    port_vis.save_images_files(x, str(tmp_path / "port"), prefix="adv",
                               labels=[4, 0, 9])
    jax_vis.save_images_files(x, str(tmp_path / "jax"), prefix="adv",
                              labels=[4, 0, 9])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "adv_00000_4.png", "adv_00001_0.png", "adv_00002_9.png"]
    for name in names:
        np.testing.assert_array_equal(_png(tmp_path / "port" / name)[1],
                                      _png(tmp_path / "jax" / name)[1])


def test_write_png_refuses_other_channel_counts(tmp_path):
    with pytest.raises(ValueError, match="grey"):
        port_vis.write_png(str(tmp_path / "x.png"),
                           np.zeros((4, 4, 2), np.uint8))
