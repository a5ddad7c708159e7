"""PyTorch port vs JAX: generators (defensegan_torch/models/generator.py).

Same weights (a JAX init, bridged) and the same z (numpy, seeded) through
both packages. float32 tolerance 1e-5: the two frameworks sum a conv or a
matmul in different orders, ~1e-7 apart at these sizes. The flagship in
bfloat16 rounds at the same points in both, but a sum taken in another
order now and then rounds to the neighbouring bf16 value: tolerance one
bf16 ulp of a tanh output, 2^-8, with at least 99% of pixels equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from defensegan_tpu.models.generator import from_image_space as jax_from
from defensegan_tpu.models.generator import generator_for as jax_generator
from defensegan_torch.ckpt.bridge import load_flax_tree, read_export
from defensegan_torch.models.generator import from_image_space, \
    generator_for, to_image_space
from defensegan_torch.models.layers import ConvTranspose

torch.set_num_threads(2)

FLAGSHIP = "output/gans/mnist_fast/export/20000.npz"


def _perturbed_init(gen, latent, seed=0):
    """JAX init with non-trivial BN statistics (numpy trees)."""
    v = gen.init(jax.random.key(seed), jnp.zeros((1, latent)))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(np.float32),
        v["params"])
    stats = jax.tree.map(
        lambda a: np.asarray(a) + 0.5 * rng.rand(*a.shape).astype(np.float32),
        v["batch_stats"])
    return params, stats


@pytest.mark.parametrize("dataset,arch", [("mnist", "wide"), ("mnist", "deep"),
                                          ("celeba", "wide"),
                                          ("celeba", "deep"),
                                          ("imagenet64", "deep")])
def test_generator_matches_jax_f32(dataset, arch):
    latent = 16
    jg = jax_generator(dataset, 4, arch=arch)
    params, stats = _perturbed_init(jg, latent)
    z = np.random.RandomState(1).randn(3, latent).astype(np.float32)
    ref = np.asarray(jg.apply({"params": params, "batch_stats": stats}, z,
                              train=False))
    tg = generator_for(dataset, 4, arch=arch, latent_dim=latent)
    load_flax_tree(tg, params, stats)
    with torch.no_grad():
        out = tg(torch.from_numpy(z)).numpy()
    assert out.shape == ref.shape == (3,) + (tg.output_hw,) * 2 + \
        (tg.out_channels,)
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flagship_export_matches_jax(dtype):
    tree = read_export(FLAGSHIP)
    p, s = tree["generator"]["params"], tree["generator"]["batch_stats"]
    z = np.random.RandomState(2).randn(16, 128).astype(np.float32)
    ref = np.asarray(jax_generator("mnist", 16, getattr(jnp, dtype), "wide")
                     .apply({"params": p, "batch_stats": s}, z, train=False))
    tg = generator_for("mnist", 16, getattr(torch, dtype), "wide", 128)
    load_flax_tree(tg, p, s)
    with torch.no_grad():
        out = tg(torch.from_numpy(z)).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-5)
    else:
        np.testing.assert_allclose(out, ref, atol=2.0 ** -8)
        assert (out == ref).mean() >= 0.99


def test_64x64_generator_matches_jax_bf16():
    """The 4-deconv CelebA generator in its configured compute dtype,
    bfloat16: params and batch stats cross as numpy, both sides round at
    the same points, and a sum taken in another order now and then rounds
    to the neighbouring bf16 value, which the next three deconvs carry
    forward: the tanh outputs agree to two bf16 ulps (2^-7), and 95% of
    them exactly."""
    latent = 16
    jg = jax_generator("celeba", 4, jnp.bfloat16, "deep")
    params, stats = _perturbed_init(jg, latent)
    z = np.random.RandomState(4).randn(3, latent).astype(np.float32)
    ref = np.asarray(jg.apply({"params": params, "batch_stats": stats}, z,
                              train=False)).astype(np.float32)
    tg = generator_for("celeba", 4, torch.bfloat16, "deep", latent)
    assert tg.channels == (32, 16, 8, 4) and tg.base_hw == 4
    load_flax_tree(tg, params, stats)
    with torch.no_grad():
        out = tg(torch.from_numpy(z)).float().numpy()
    assert out.shape == ref.shape == (3, 64, 64, 3)
    np.testing.assert_allclose(out, ref, atol=2.0 ** -7)
    assert (out == ref).mean() >= 0.95


def test_conv_transpose_is_flax_same_unflipped():
    """The trap pinned: flax's SAME stride-2 ConvTranspose is a plain
    correlation of the dilated input padded (3, 2) with the UNflipped
    kernel. The port's layer must equal that written out by hand, and
    lax.conv_transpose itself."""
    rng = np.random.RandomState(3)
    kern = rng.randn(5, 5, 3, 2).astype(np.float32)          # HWIO
    x = rng.randn(2, 6, 6, 3).astype(np.float32)             # NHWC
    ref = np.asarray(jax.lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(kern), strides=(2, 2), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    layer = ConvTranspose(3, 2)
    load_flax_tree(torch.nn.ModuleDict({"d": layer}),
                   {"d": {"kernel": kern, "bias": np.zeros(2, np.float32)}})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = layer(xt).permute(0, 2, 3, 1).numpy()
    dil = torch.zeros(2, 3, 11, 11)
    dil[:, :, ::2, ::2] = xt
    by_hand = F.conv2d(F.pad(dil, (3, 2, 3, 2)),
                       torch.from_numpy(kern).permute(3, 2, 0, 1))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(by_hand.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-5)


def test_uint8_ingest_matches_jax_and_float():
    x8 = np.arange(0, 256, dtype=np.uint8).reshape(1, 16, 16, 1)
    ref = np.asarray(jax_from(jnp.asarray(x8)))
    got = from_image_space(torch.from_numpy(x8)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    fl = from_image_space(torch.from_numpy(x8).float() / 255.0).numpy()
    np.testing.assert_allclose(got, fl, atol=1e-6)
    assert got.min() == -1.0 and got.max() == 1.0
    np.testing.assert_allclose(to_image_space(torch.tensor(got)).numpy(),
                               x8 / 255.0, atol=1e-6)
