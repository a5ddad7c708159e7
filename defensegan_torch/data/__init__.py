"""Data: MNIST / Fashion-MNIST / digits / CelebA / ImageNet-64 readers with
the deterministic synthetic fallback (port of the JAX package's data/).

Images are float32 numpy arrays in [0, 1], NHWC. Real files are parsed
when present under data_dir (IDX for MNIST / F-MNIST, aligned JPEGs +
list_attr_celeba.txt for CelebA, npz shards for ImageNet-64; sklearn's
bundled digits); otherwise the synthetic stand-in keeps every pipeline
runnable with no download.
"""

from defensegan_torch.data.dataset import Dataset, get_dataset

__all__ = ["Dataset", "get_dataset"]
