"""PyTorch port vs JAX: packed generators (defensegan_torch/defense/
fastgen.py).

The packs are host arithmetic on the same float32 weights, so w_fc, b_fc,
the probed dense D, the probed s2d grid-conv kernels, the phase
sub-kernels and the s2d permutations must EQUAL the JAX package's, bit for
bit (both in float32 and rounded to bfloat16). The packed applies must
equal G(z) to float32 summation-order tolerance, 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.defense import fastgen as jfast
from defensegan_tpu.models.generator import generator_for as jax_generator
from defensegan_torch.ckpt.bridge import (conv_transpose_weight,
                                          load_flax_tree, read_export)
from defensegan_torch.defense.fastgen import (_probe_grid_conv, _s2d,
                                              _s2d_flat_perm, _s2d_inv,
                                              apply_phase_conv,
                                              make_packed_apply,
                                              pack_generator)
from defensegan_torch.models.layers import conv_transpose_same
from defensegan_torch.models.generator import generator_for

torch.set_num_threads(2)


def _pair(arch, dtype="float32", dim=4, latent=16, seed=0, dataset="mnist"):
    jg = jax_generator(dataset, dim, getattr(jnp, dtype), arch)
    v = jg.init(jax.random.key(seed), jnp.zeros((1, latent)))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.randn(
        *a.shape).astype(np.float32), v["params"])
    stats = jax.tree.map(lambda a: np.asarray(a) + 0.5 * rng.rand(
        *a.shape).astype(np.float32), v["batch_stats"])
    tg = generator_for(dataset, dim, getattr(torch, dtype), arch, latent)
    load_flax_tree(tg, params, stats)
    return jg, params, stats, tg.requires_grad_(False)


def _np(t):
    return t.float().numpy()


@pytest.fixture
def float32_products():
    """Products in full float32 on both sides for the test's duration: JAX
    at "highest" instead of its backend's DEFAULT (which a backend may run
    in fewer-pass algorithms), torch at "highest" whatever an earlier test
    of the process set."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_float32_matmul_precision(before)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_pack_equals_jax(dtype):
    jg, params, stats, tg = _pair("wide", dtype)
    jp = jfast.pack_generator(jg, params, stats, variant="dense")
    tp = pack_generator(tg, "dense")
    assert tp.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(tp.w_fc), np.asarray(jp.w_fc,
                                                           np.float32))
    np.testing.assert_array_equal(_np(tp.b_fc), np.asarray(jp.b_fc,
                                                           np.float32))
    for got, ref in zip(tp.dense, jp.dense):
        np.testing.assert_array_equal(_np(got), np.asarray(ref, np.float32))


def test_flagship_dense_pack_equals_jax():
    tree = read_export("output/gans/mnist_fast/export/20000.npz")
    p, s = tree["generator"]["params"], tree["generator"]["batch_stats"]
    jg = jax_generator("mnist", 16, jnp.bfloat16, "wide")
    jp = jfast.pack_generator(jg, p, s, variant="dense")
    tg = generator_for("mnist", 16, torch.bfloat16, "wide", 128)
    load_flax_tree(tg, p, s)
    tp = pack_generator(tg, "dense")
    assert tuple(tp.dense[0].shape) == (6272, 784)
    np.testing.assert_array_equal(_np(tp.dense[0]),
                                  np.asarray(jp.dense[0], np.float32))
    np.testing.assert_array_equal(_np(tp.w_fc),
                                  np.asarray(jp.w_fc, np.float32))


def _eq(got, ref, msg=""):
    np.testing.assert_array_equal(_np(got), np.asarray(ref, np.float32),
                                  err_msg=msg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_s2d_pack_equals_jax(dtype):
    jg, params, stats, tg = _pair("deep", dtype)
    jp = jfast.pack_generator(jg, params, stats, variant="s2d")
    tp = pack_generator(tg, "s2d")
    assert tp.dtype == getattr(torch, dtype) and tp.variant == "s2d"
    assert (tp.base_hw, tp.out_hw, tp.out_channels) == (7, 28, 1)
    _eq(tp.w_fc, jp.w_fc)
    _eq(tp.b_fc, jp.b_fc)
    assert len(tp.convs) == len(jp.convs) == 2
    for (gk, gb, grelu), (rk, rb, rrelu) in zip(tp.convs, jp.convs):
        assert tuple(gk.shape) == tuple(rk.shape) and grelu == rrelu
        _eq(gk, rk, "s2d kernel")
        _eq(gb, rb, "s2d bias")
    assert tuple(tp.convs[0][0].shape) == (3, 3, 8, 16)
    assert tuple(tp.convs[1][0].shape) == (3, 3, 16, 16)
    for got, ref in zip(tp.perm, jp.perm):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # perm maps image-flat to s2d-flat; inv_perm restores image order
    img = torch.arange(784.0)[None]
    assert torch.equal(img[:, tp.perm[0]][:, tp.perm[1]], img)


def test_phase_pack_equals_jax():
    jg, params, stats, tg = _pair("deep")
    jp = jfast.pack_generator(jg, params, stats, variant="phase")
    tp = pack_generator(tg, "phase")
    for (gpc, grelu), (rpc, rrelu) in zip(tp.convs, jp.convs):
        assert grelu == rrelu and gpc.pads == rpc.pads
        _eq(gpc.bias, rpc.bias)
        for p in range(2):
            for q in range(2):
                _eq(gpc.kernels[p][q], rpc.kernels[p][q], f"phase {p}{q}")
    # one phase conv alone equals the SAME stride-2 transpose conv
    pc, _ = tp.convs[0]
    h = torch.from_numpy(np.random.RandomState(3).randn(2, 7, 7, 8)
                         .astype(np.float32))
    folded, bias, _ = pack_generator(tg, "conv").convs[0]
    ref = conv_transpose_same(h.permute(0, 3, 1, 2), folded).permute(
        0, 2, 3, 1) + bias
    np.testing.assert_allclose(apply_phase_conv(pc, h).numpy(), ref.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("arch", ["deep", "wide"])
def test_hybrid_pack_equals_jax(arch):
    jg, params, stats, tg = _pair(arch)
    jp = jfast.pack_generator(jg, params, stats, variant="hybrid")
    tp = pack_generator(tg, "hybrid")
    assert len(tp.convs) == len(jp.convs) == (1 if arch == "deep" else 0)
    for got, ref in zip(tp.dense, jp.dense):
        assert tuple(got.shape) == tuple(ref.shape)
        _eq(got, ref)


def test_s2d_helpers_match_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 28, 28, 3).astype(np.float32)
    for f in (2, 4):
        ref = np.asarray(jfast._s2d(jnp.asarray(x), f))
        got = _s2d(torch.from_numpy(x), f)
        np.testing.assert_array_equal(got.numpy(), ref)
        back = _s2d_inv(got, f, 3)
        np.testing.assert_array_equal(back.numpy(), x)
        np.testing.assert_array_equal(_s2d_flat_perm(28, f, 3),
                                      jfast._s2d_flat_perm(28, f, 3))


def test_probe_grid_conv_raises_on_a_small_window():
    """A 5x5 SAME conv probed with a 3x3 window spills outside it: the
    probe must refuse instead of truncating; a 5x5 window recovers the
    kernel exactly."""
    kern = torch.from_numpy(np.random.RandomState(5).randn(2, 3, 5, 5)
                            .astype(np.float32))          # OIHW

    def lin_fn(x):
        y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), kern,
                                       padding=2)
        return y.permute(0, 2, 3, 1)

    with pytest.raises(ValueError, match="exceeds window=3"):
        _probe_grid_conv(lin_fn, 7, 3)
    got = _probe_grid_conv(lin_fn, 7, 3, window=5)
    np.testing.assert_array_equal(got, kern.permute(2, 3, 1, 0).numpy())


@pytest.mark.parametrize("arch,variant", [("wide", "dense"), ("wide", "conv"),
                                          ("deep", "conv"), ("deep", "phase"),
                                          ("wide", "phase"),
                                          ("deep", "hybrid"),
                                          ("wide", "hybrid")])
def test_packed_apply_equals_generator(arch, variant, float32_products):
    """1e-5 is far above float32 summation order (the two sides differ by
    3.6e-7 on wide-dense, and a sequential or reversed order of its
    1568-term sums moves an output by under 2e-7), not above products in
    fewer bits: both sides run theirs in full float32 (`float32_products`)."""
    jg, params, stats, tg = _pair(arch)
    z = np.random.RandomState(1).randn(4, 16).astype(np.float32)
    ref = np.asarray(jg.apply({"params": params, "batch_stats": stats}, z,
                              train=False)).reshape(4, -1)
    apply_flat = make_packed_apply(pack_generator(tg, variant))
    got = apply_flat(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    jref = np.asarray(jfast.make_packed_apply(jfast.pack_generator(
        jg, params, stats, variant=variant))(jnp.asarray(z)))
    np.testing.assert_allclose(got, jref, atol=1e-5)


@pytest.mark.parametrize("arch,dtype", [("deep", "float32"),
                                        ("wide", "float32"),
                                        ("deep", "bfloat16")])
def test_conv_pack_of_a_64x64_stack_equals_jax(arch, dtype):
    """The 3- and 4-deconv generators of the 64x64 configs: the conv pack
    (the fused v4 loop's source) equals the JAX package's bit for bit, and
    its apply equals G(z) (float32: 1e-5, summation order)."""
    jg, params, stats, tg = _pair(arch, dtype, dataset="celeba")
    jp = jfast.pack_generator(jg, params, stats, variant="conv")
    tp = pack_generator(tg, "conv")
    n = 4 if arch == "deep" else 3
    assert len(tp.convs) == len(jp.convs) == n
    assert (tp.base_hw, tp.out_hw, tp.out_channels) == \
        (4 if arch == "deep" else 8, 64, 3)
    _eq(tp.w_fc, jp.w_fc)
    _eq(tp.b_fc, jp.b_fc)
    for (gk, gb, grelu), (rk, rb, rrelu) in zip(tp.convs, jp.convs):
        assert grelu == rrelu
        # the port keeps torch's transpose-conv layout, [in, out, kh, kw]
        # with both spatial axes flipped (ckpt/bridge.py)
        _eq(gk.flip(2, 3).permute(2, 3, 0, 1), rk, "conv kernel")
        _eq(gb, rb, "conv bias")
    if dtype == "float32":
        z = np.random.RandomState(1).randn(3, 16).astype(np.float32)
        ref = np.asarray(jg.apply({"params": params, "batch_stats": stats},
                                  z, train=False)).reshape(3, -1)
        got = make_packed_apply(tp)(torch.from_numpy(z)).numpy()
        assert got.shape == (3, 64 * 64 * 3)
        np.testing.assert_allclose(got, ref, atol=1e-5)
        jref = np.asarray(jfast.make_packed_apply(jp)(jnp.asarray(z)))
        np.testing.assert_allclose(got, jref, atol=1e-5)


@pytest.mark.parametrize("level", ["mid", "out"])
def test_probe_grid_conv_on_the_levels_of_a_64x64_stack(level):
    """The two linear maps the fused v4 loop probes: a mid level (stride-2
    deconv, then space-to-depth: [g, g, ci] -> [g, g, 4 co]) and the folded
    out level (inverse s2d, out deconv, two s2ds: [g, g, 4 ci] ->
    [g, g, 16 out_c]). Each has 3x3 support on its grid (the probe raises
    past it), equals the JAX probe of the same map bit for bit, and the
    probed kernel applied as a 3x3 SAME conv reproduces the map."""
    rng = np.random.RandomState(7)
    ci, co, g = (6, 5, 4) if level == "mid" else (4, 3, 4)
    kern = rng.randn(5, 5, ci, co).astype(np.float32)          # HWIO
    w = torch.from_numpy(conv_transpose_weight(kern).copy())

    def jdeconv(x):
        return jax.lax.conv_transpose(
            x, jnp.asarray(kern), strides=(2, 2), padding="SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    def tdeconv(x):
        return conv_transpose_same(x.permute(0, 3, 1, 2), w).permute(
            0, 2, 3, 1)

    if level == "mid":
        lanes = ci
        jlin = lambda x: jfast._s2d(jdeconv(x), 2)
        tlin = lambda x: _s2d(tdeconv(x), 2)
    else:
        lanes = 4 * ci
        jlin = lambda x: jfast._s2d(jfast._s2d(
            jdeconv(jfast._s2d_inv(x, 2, ci)), 2), 2)
        tlin = lambda x: _s2d(_s2d(tdeconv(_s2d_inv(x, 2, ci)), 2), 2)
    got = _probe_grid_conv(tlin, g, lanes)
    ref = np.asarray(jfast._probe_grid_conv(jlin, g, lanes))
    assert got.shape == ref.shape == \
        (3, 3, lanes, 4 * co if level == "mid" else 16 * co)
    np.testing.assert_array_equal(got, ref)
    x = torch.from_numpy(rng.randn(2, g, g, lanes).astype(np.float32))
    conv = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), torch.from_numpy(got).permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(conv.numpy(), tlin(x).numpy(), atol=1e-5)


def test_bf16_dense_apply_matches_jax():
    """The dense apply's epilogue runs in the compute dtype (bf16 for the
    flagship) and rounds after each product, bias add and tanh, as JAX's
    does: one bf16 ulp (2^-8) tolerance for summation-order rounding."""
    jg, params, stats, tg = _pair("wide", "bfloat16")
    z = np.random.RandomState(2).randn(8, 16).astype(np.float32)
    jref = np.asarray(jfast.make_packed_apply(jfast.pack_generator(
        jg, params, stats, variant="dense"))(jnp.asarray(z)))
    got = make_packed_apply(pack_generator(tg, "dense"))(
        torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, jref, atol=2.0 ** -8)


def test_s2d_apply_equals_generator_up_to_the_permutation():
    jg, params, stats, tg = _pair("deep")
    z = np.random.RandomState(1).randn(4, 16).astype(np.float32)
    ref = np.asarray(jg.apply({"params": params, "batch_stats": stats}, z,
                              train=False)).reshape(4, -1)
    packed = pack_generator(tg, "s2d")
    got = make_packed_apply(packed)(torch.from_numpy(z))
    np.testing.assert_allclose(got[:, packed.perm[1]].numpy(), ref,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref[:, packed.perm[0].numpy()],
                               atol=1e-5)
    jref = np.asarray(jfast.make_packed_apply(jfast.pack_generator(
        jg, params, stats, variant="s2d"))(jnp.asarray(z)))
    np.testing.assert_allclose(got.numpy(), jref, atol=1e-5)


def test_bf16_s2d_apply_matches_jax():
    """The s2d apply computes in the compute dtype and rounds after each
    conv, bias add and tanh, as JAX's does; the two convolutions sum in
    different orders, which flips a bf16 rounding of a hidden activation
    now and then: the tanh outputs agree to two bf16 ulps (2^-7), and
    95% of them exactly."""
    jg, params, stats, tg = _pair("deep", "bfloat16")
    z = np.random.RandomState(2).randn(8, 16).astype(np.float32)
    jref = np.asarray(jfast.make_packed_apply(jfast.pack_generator(
        jg, params, stats, variant="s2d"))(jnp.asarray(z)))
    got = make_packed_apply(pack_generator(tg, "s2d"))(
        torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, jref, atol=2.0 ** -7)
    assert (got == jref).mean() >= 0.95


def test_unported_variants_raise():
    """Every variant of the JAX package packs in the port; what still
    raises is what raises there: an unknown variant, dense on a deep
    stack, s2d on more than two deconvs."""
    _, _, _, tg = _pair("deep")
    for variant in ("s2d", "phase", "hybrid"):
        assert pack_generator(tg, variant).variant == variant
    with pytest.raises(ValueError, match="unknown packed variant"):
        pack_generator(tg, "s3d")
    with pytest.raises(ValueError, match="single-deconv"):
        pack_generator(tg, "dense")
    celeba = generator_for("celeba", 2, torch.float32, "deep", 16)
    with pytest.raises(ValueError, match="at most two deconvs"):
        pack_generator(celeba, "s2d")
    with pytest.raises(ValueError, match="too large"):
        pack_generator(generator_for("celeba", 32, torch.float32, "wide",
                                     16), "hybrid")
