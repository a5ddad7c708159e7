"""PyTorch port vs JAX: the data loaders (defensegan_torch/data/), array
for array.

The port keeps its own copy of the JAX package's data modules; on the same
arguments both return equal arrays: the synthetic stand-in (every split,
style and margin), sklearn's bundled digits, IDX files when present, and
the registry with its synthetic fallback.
"""

import gzip
import struct

import numpy as np
import pytest

from defensegan_tpu.data import dataset as jax_dataset
from defensegan_tpu.data import synthetic as jax_synthetic
from defensegan_torch.data import dataset, get_dataset, synthetic


@pytest.mark.parametrize("split", ["train", "dev", "test"])
@pytest.mark.parametrize("style,margin", [("smooth", None),
                                          ("sparse", None),
                                          ("smooth", 6.0)])
def test_make_synthetic_equals_jax(split, style, margin):
    kw = dict(image_size=28, channels=1, num_classes=10, seed=3,
              split=split, margin=margin, style=style)
    x, y = synthetic.make_synthetic(64, **kw)
    rx, ry = jax_synthetic.make_synthetic(64, **kw)
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)
    assert x.dtype == np.float32 and y.dtype == np.int32


def test_synthetic_protos_and_margin_equal_jax():
    p = synthetic.synthetic_protos(8, 3, 4, seed=1, margin=2.0)
    np.testing.assert_array_equal(p, jax_synthetic.synthetic_protos(
        8, 3, 4, seed=1, margin=2.0))
    assert synthetic.min_pairwise_l2(p) == jax_synthetic.min_pairwise_l2(p)


@pytest.mark.parametrize("split", ["train", "dev", "test"])
def test_digits_equal_jax(split):
    x, y = dataset.Digits().load(split)
    rx, ry = jax_dataset.Digits().load(split)
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)
    assert x.shape[1:] == (28, 28, 1)


@pytest.mark.parametrize("name", ["mnist", "f-mnist", "celeba"])
def test_registry_fallback_equals_jax(name, tmp_path):
    ds = get_dataset(name, data_dir=str(tmp_path), seed=2)
    ref = jax_dataset.get_dataset(name, data_dir=str(tmp_path), seed=2)
    for split in ("dev", "test"):
        for got, want in zip(ds.load(split), ref.load(split)):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(ds.load_u8("dev"), ref.load_u8("dev")):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        get_dataset("nope")
    with pytest.raises(ValueError):
        ds.load("nope")


def _idx(path, arr, code):
    header = struct.pack(">HBB", 0, code, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    with gzip.open(path, "wb") as f:
        f.write(header + arr.astype(arr.dtype.newbyteorder(">")).tobytes())


def test_mnist_idx_files_parse_like_jax(tmp_path):
    rng = np.random.RandomState(0)
    root = tmp_path / "mnist"
    root.mkdir()
    for kind, n in (("train", 5010), ("t10k", 7)):
        _idx(root / f"{kind}-images-idx3-ubyte.gz",
             rng.randint(0, 256, (n, 28, 28)).astype(np.uint8), 0x08)
        _idx(root / f"{kind}-labels-idx1-ubyte.gz",
             rng.randint(0, 10, n).astype(np.uint8), 0x08)
    ds = dataset.Mnist(data_dir=str(tmp_path))
    ref = jax_dataset.Mnist(data_dir=str(tmp_path))
    for split, n in (("train", 10), ("dev", 5000), ("test", 7)):
        x, y = ds.load(split)
        rx, ry = ref.load(split)
        assert x.shape == (n, 28, 28, 1)
        # the JAX package may parse through its optional native loader,
        # which scales by 1/255 (one float32 ulp off u8 / 255 at most);
        # the port keeps that package's numpy path, u8 / 255
        np.testing.assert_allclose(x, rx, rtol=0, atol=6e-8)
        np.testing.assert_array_equal(y, ry)
    kind = str(root / "t10k-images-idx3-ubyte.gz")
    np.testing.assert_array_equal(
        dataset._read_idx_images(kind),
        jax_dataset._read_idx(kind).astype(np.float32) / 255.0)
