"""PyTorch port vs JAX: fused projection v4, the multi-deconv loop of the
64x64 generators (defensegan_torch/kernels/fused_projection_v4.py).

On the CPU the wrapper runs the kernel's plain version; it is held against
the Pallas kernel in interpret mode (GEN_DIM 4, LATENT_DIM 16, tile 2, as
tests/test_fused_v4.py runs it) for 4 levels (celeba deep), 3 (celeba
wide) and 2 (MNIST deep, no interleave). The port keeps every bf16
rounding of the TPU kernel, the per-tap rounding of the backward convs
included, so both sides round at the same points and differ only in
float32 summation order. Tolerance on z_final: 1e-6 absolute (v3's test
reaches 1.2e-7; here the two agree exactly on the 64x64 stacks, whose sums
at these widths are short, and to 6e-8 on the MNIST deep topology), and at
most 1% of how far the loop moved z: with lr 10 the seeded tiny 64x64
generators move z by 1.5e-4 per step (the loss's mean runs over 12288
outputs), where a misplaced tap, lane or interleave changes the gradient,
and so the move, by tens of percent. The CUDA kernel itself is held against
the same plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import defensegan_tpu.kernels.fused_projection_v4 as jv4
from defensegan_tpu.configs import Config as JaxConfig
from defensegan_tpu.gan import DefenseGAN as JaxGAN
from defensegan_torch.ckpt.bridge import load_flax_tree
from defensegan_torch.defense.fastgen import _s2d, _s2d_inv
from defensegan_torch.kernels import build
from defensegan_torch.kernels import fused_projection_v4 as v4
from defensegan_torch.kernels.conv3x3 import COUNTER as CONV3X3_COUNTER
from defensegan_torch.kernels.conv3x3 import (conv3x3, conv3x3_plain,
                                              rounding_excess, to_blocked,
                                              to_fine)
from defensegan_torch.kernels.fused_projection_v4 import (
    fused_projection_v4, interleave_perm, make_v4_reconstructor, pack_v4,
    padded_targets, padded_v4, v4_kernel_available, v4_loop_plain, v4_state,
    x_rows)
from defensegan_torch.kernels.grid import pixel_order, tap_masks
from defensegan_torch.kernels.loop import run_loop
from defensegan_torch.models.generator import generator_for

torch.set_num_threads(2)

LATENT, LR, MOM, TILE = 16, 10.0, 0.7, 2
V4 = "fused_projection_v4"
# (dataset, arch, image size, channels, levels as (g, ci, co, interleave))
TOPOLOGIES = {
    "celeba_deep": ("celeba", "deep", 64, 3,
                    [(4, 32, 64, 16), (8, 16, 32, 8), (16, 8, 16, None),
                     (16, 16, 48, None)]),
    "celeba_wide": ("celeba", "wide", 64, 3,
                    [(8, 16, 32, 8), (16, 8, 16, None), (16, 16, 48, None)]),
    "mnist_deep": ("mnist", "deep", 28, 1,
                   [(7, 8, 16, None), (7, 16, 16, None)]),
}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Per topology: a JAX DefenseGAN with non-trivial BatchNorm statistics
    (so no BN fold is the identity) and the port's generator holding the
    same arrays."""
    made = {}

    def get(name):
        if name not in made:
            dataset, arch, size, ch, _ = TOPOLOGIES[name]
            cfg = JaxConfig(type=dataset, gen_arch=arch, gen_dim=4,
                            disc_dim=4, latent_dim=LATENT, image_size=size,
                            channels=ch, rec_rr=2, rec_iters=5,
                            compute_dtype="bfloat16",
                            projection_kernel="xla",
                            output_dir=str(tmp_path_factory.mktemp(name)))
            jgan = JaxGAN(cfg)
            rng = np.random.RandomState(0)
            stats = jax.tree.map(
                lambda a: np.asarray(a)
                + 0.5 * rng.rand(*a.shape).astype(np.float32),
                jgan.state.gen_stats)
            params = jax.tree.map(np.asarray, jgan.state.gen_params)
            for bn in (n for n in params if n.startswith("bn_")):
                shape = params[bn]["scale"].shape
                params[bn]["scale"] = params[bn]["scale"] + \
                    0.3 * rng.randn(*shape).astype(np.float32)
                params[bn]["bias"] = 0.2 * rng.randn(*shape).astype(
                    np.float32)
            jgan.state = jgan.state.replace(gen_params=params,
                                            gen_stats=stats)
            tg = generator_for(dataset, 4, torch.bfloat16, arch, LATENT)
            load_flax_tree(tg, params, stats)
            made[name] = (jgan, tg.requires_grad_(False))
        return made[name]

    return get


def _inputs(name, n=4, seed=0):
    _, _, size, ch, _ = TOPOLOGIES[name]
    rng = np.random.RandomState(seed)
    x = np.tanh(rng.randn(n, size, size, ch)).astype(np.float32)
    return x, rng.randn(n, LATENT).astype(np.float32)


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_pack_equals_jax(pairs, name):
    jgan, tg = pairs(name)
    jp, tp = jv4.V4Pack(jgan), pack_v4(tg)
    assert (tp.base_hw, tp.out_hw, tp.out_c, tp.z_dim, tp.c0, tp.final_g,
            tp.out_lanes) == (jp.base_hw, jp.out_hw, jp.out_c, jp.z_dim,
                              jp.c0, jp.final_g, jp.out_lanes)
    assert tp.out_dim == tp.out_hw ** 2 * tp.out_c
    for f in ("w1", "w1t", "b1"):
        np.testing.assert_array_equal(getattr(tp, f).float().numpy(),
                                      np.asarray(getattr(jp, f), np.float32),
                                      err_msg=f)
    assert [(lv.g, lv.ci, lv.co, lv.interleave_after)
            for lv in tp.levels] == TOPOLOGIES[name][4]
    assert len(tp.levels) == len(jp.levels)
    for got, ref in zip(tp.levels, jp.levels):
        assert (got.g, got.ci, got.co, got.relu, got.interleave_after) == \
            (ref["g"], ref["ci"], ref["co"], ref["relu"],
             ref["interleave_after"])
        for f, dt in (("w", torch.bfloat16), ("wt", torch.bfloat16),
                      ("b", torch.float32)):
            t = getattr(got, f)
            assert t.dtype == dt and tuple(t.shape) == ref[f].shape
            np.testing.assert_array_equal(
                t.float().numpy(), np.asarray(ref[f], np.float32), err_msg=f)
    assert [lv.relu for lv in tp.levels] == \
        [True] * (len(tp.levels) - 1) + [False]


@pytest.mark.parametrize("g,c", [(4, 16), (8, 8), (2, 64)])
def test_interleave_maps_equal_jax(g, c):
    """The flat map the CUDA kernel stores and reads through equals the JAX
    kernel's _interleave / _interleave_inv (pixel-major rows of a tile, so
    tile 1 is one latent) and the plain version's _s2d_inv / _s2d."""
    rng = np.random.RandomState(g)
    blocked = rng.randn(g * g, 4 * c).astype(np.float32)
    fine = np.asarray(jv4._interleave(jnp.asarray(blocked), g, 1, c))
    perm = interleave_perm(g, c)
    assert sorted(perm) == list(range(g * g * 4 * c))
    np.testing.assert_array_equal(blocked.reshape(-1)[perm],
                                  fine.reshape(-1))
    back = np.asarray(jv4._interleave_inv(jnp.asarray(fine), g, 1, c))
    np.testing.assert_array_equal(back, blocked)
    tb = torch.from_numpy(blocked).reshape(1, g, g, 4 * c)
    tf = _s2d_inv(tb, 2, c)
    np.testing.assert_array_equal(tf.reshape(-1).numpy(), fine.reshape(-1))
    assert torch.equal(_s2d(tf, 2), tb)


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_x_rows_equal_jax_up_to_the_tile_order(pairs, name):
    jgan, tg = pairs(name)
    jp, tp = jv4.V4Pack(jgan), pack_v4(tg)
    x, _ = _inputs(name)
    n, p2, lanes = 4, tp.final_g ** 2, tp.out_lanes
    ref = np.asarray(jp.x_rows(jnp.asarray(x), TILE))    # [p2 * n, lanes]
    ref = ref.reshape(n // TILE, p2, TILE, lanes).transpose(0, 2, 1, 3)
    got = x_rows(tp, torch.from_numpy(x))
    assert tuple(got.shape) == (n, tp.out_dim)
    np.testing.assert_array_equal(got.numpy(), ref.reshape(n, p2 * lanes))


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_plain_loop_matches_pallas_interpret(pairs, name, steps):
    jgan, tg = pairs(name)
    jp, tp = jv4.V4Pack(jgan), pack_v4(tg)
    x, z0 = _inputs(name)
    ref = np.asarray(jv4.fused_projection_v4(
        jp, jp.x_rows(jnp.asarray(x), TILE), jnp.asarray(z0),
        rec_iters=steps, rec_lr=LR, momentum=MOM, tile=TILE,
        interpret=True))
    before = build.LAUNCHES[V4]
    got = fused_projection_v4(tp, x_rows(tp, torch.from_numpy(x)),
                              torch.from_numpy(z0), rec_iters=steps,
                              rec_lr=LR, momentum=MOM).numpy()
    # the CPU path is the plain version: no kernel launch is counted
    assert build.LAUNCHES[V4] == before
    moved = np.abs(got - z0).max()
    assert moved > 1e-5 * steps                  # the loop moved z
    np.testing.assert_allclose(got, ref, atol=min(1e-6, 1e-2 * moved))


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_reconstructor_matches_pallas_interpret(pairs, name):
    """Epilogue included: same x and injected z0 -> the same [B, R] final
    losses, argmins and x_hat in image order. Loss tolerance 1e-4: the
    epilogue's images are bf16, and the two packed applies sum a conv in
    different orders, which flips a pixel's rounding now and then; x_hat
    within 1e-2 (a few bf16 ulps of a [0, 1] pixel)."""
    jgan, tg = pairs(name)
    _, _, size, ch, _ = TOPOLOGIES[name]
    rng = np.random.RandomState(1)
    x = rng.rand(2, size, size, ch).astype(np.float32)
    z0 = rng.randn(2, 2, LATENT).astype(np.float32)
    ref = jv4.make_v4_reconstructor(
        jgan, rec_rr=2, rec_iters=5, rec_lr=LR, momentum=MOM, tile=TILE,
        interpret=True)(jnp.asarray(x), jax.random.key(0), jnp.asarray(z0))
    got = make_v4_reconstructor(
        tg, (size, size, ch), rec_rr=2, rec_iters=5, rec_lr=LR,
        momentum=MOM)(torch.from_numpy(x), z0=torch.from_numpy(z0))
    np.testing.assert_allclose(got.all_losses.numpy(),
                               np.asarray(ref.all_losses), atol=1e-4)
    np.testing.assert_array_equal(got.all_losses.numpy().argmin(1),
                                  np.asarray(ref.all_losses).argmin(1))
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(ref.loss),
                               atol=1e-4)
    np.testing.assert_allclose(got.z_star.numpy(), np.asarray(ref.z_star),
                               atol=1e-6)
    np.testing.assert_allclose(got.x_hat.numpy(), np.asarray(ref.x_hat),
                               atol=1e-2)
    assert got.x_hat.shape == (2, size, size, ch)


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_padded_pack_computes_the_same_loop(pairs, name):
    """The CUDA wrapper pads k, c0 and every run of fine channels to 64 and
    the out level's lanes to 64; zero rows, columns, biases and targets
    must not change the function: the plain loop on the padded pack equals
    the unpadded one on the true latents (1e-7: the longer sums add exact
    zeros) and keeps the padded ones at exactly zero."""
    _, tg = pairs(name)
    pack = pack_v4(tg)
    pp = padded_v4(pack)
    assert (pp.z_dim, pp.c0) == (64, 64)
    for lv, plv in zip(pack.levels, pp.levels):
        assert plv.g == lv.g and plv.ci % 64 == 0 and plv.co % 64 == 0
        assert tuple(plv.w.shape) == (9 * plv.ci, plv.co)
        assert tuple(plv.wt.shape) == (9 * plv.co, plv.ci)
        assert (plv.interleave_after is None) == \
            (lv.interleave_after is None)
        if plv.interleave_after is not None:
            assert plv.interleave_after == 64 and plv.co == 256
    assert pp.levels[-1].co == 64 and pp.out_dim == pack.out_dim
    x, z0 = _inputs(name, seed=3)
    xr = x_rows(pack, torch.from_numpy(x))
    kw = dict(rec_iters=3, rec_lr=LR, momentum=MOM)
    ref = v4_loop_plain(pack, xr, torch.from_numpy(z0), **kw)
    z0p = torch.zeros(4, 64)
    z0p[:, :LATENT] = torch.from_numpy(z0)
    xp = padded_targets(pack, xr)
    assert xp.dtype == torch.bfloat16 and \
        tuple(xp.shape) == (4, pack.final_g ** 2 * 64)
    got = v4_loop_plain(pp, xp, z0p, **kw)
    assert torch.equal(got[:, LATENT:], torch.zeros(4, 64 - LATENT))
    np.testing.assert_allclose(got[:, :LATENT].numpy(), ref.numpy(),
                               atol=1e-7)


@pytest.mark.parametrize("cfg_name,dim,latent,widths", [
    ("celeba", 64, 128, [(4, 512, 1024, 256), (8, 256, 512, 128),
                         (16, 128, 256, None), (16, 256, 64, None)]),
    ("celeba_wide", 64, 128, [(8, 256, 512, 128), (16, 128, 256, None),
                              (16, 256, 64, None)]),
    ("imagenet64", 96, 256, [(4, 768, 1536, 384), (8, 384, 768, 192),
                             (16, 192, 384, None), (16, 384, 64, None)]),
])
def test_published_widths_pad_only_the_out_level(cfg_name, dim, latent,
                                                 widths):
    """At the published widths every level already fits the kernel's tiles
    (fine runs multiples of 64): padding touches only the out level's 48
    lanes. Checked on the level list alone, with empty weights."""
    arch = "wide" if cfg_name == "celeba_wide" else "deep"
    gen = generator_for("celeba", dim, arch=arch, latent_dim=latent)
    assert v4_kernel_available(gen)
    g, c = gen.base_hw, gen.channels[0]
    levels, lanes = [], c
    for i, co in enumerate(gen.channels[1:]):
        inter = co if i < len(gen.channels) - 2 else None
        levels.append((g, lanes, 4 * co, inter))
        g, lanes = (2 * g, co) if inter else (g, 4 * co)
    levels.append((g, lanes, 48, None))
    empty = torch.zeros(0)
    pack = v4.V4Pack(
        w1=torch.zeros(latent, gen.base_hw ** 2 * c), w1t=empty,
        b1=torch.zeros(gen.base_hw ** 2, c),
        levels=tuple(v4.V4Level(g, ci, co, i < len(levels) - 1, inter,
                                torch.zeros(9 * ci, co, dtype=torch.bfloat16),
                                torch.zeros(9 * co, ci, dtype=torch.bfloat16),
                                torch.zeros(1, co))
                     for i, (g, ci, co, inter) in enumerate(levels)),
        base_hw=gen.base_hw, out_hw=64, out_c=3, z_dim=latent, c0=c,
        out_dim=64 * 64 * 3)
    pack = pack._replace(w1t=pack.w1.t().contiguous())
    pp = padded_v4(pack)
    assert [(lv.g, lv.ci, lv.co, lv.interleave_after)
            for lv in pp.levels] == widths
    assert pp.z_dim == latent and pp.c0 == c
    for lv, plv in zip(pack.levels[:-1], pp.levels[:-1]):
        # nothing copied: the padded level views the pack's own storage
        for f in ("w", "wt", "b"):
            assert getattr(plv, f).data_ptr() == getattr(lv, f).data_ptr()


def test_single_deconv_generator_is_rejected():
    wide = generator_for("mnist", 4, arch="wide", latent_dim=LATENT)
    assert not v4_kernel_available(wide)
    with pytest.raises(ValueError, match="single-deconv"):
        pack_v4(wide)
    with pytest.raises(ValueError, match="single-deconv"):
        make_v4_reconstructor(wide, (28, 28, 1), rec_rr=2, rec_iters=1,
                              rec_lr=LR, momentum=MOM)


def test_v4_kernel_available():
    assert v4_kernel_available(generator_for("celeba", 4, arch="deep"))
    assert v4_kernel_available(generator_for("celeba", 4, arch="wide"))
    assert v4_kernel_available(generator_for("mnist", 4, arch="deep"))
    assert v4_kernel_available(generator_for("imagenet64", 96, arch="deep"))
    assert not v4_kernel_available(generator_for("mnist", 4, arch="wide"))
    # past the JAX package's bound, channels[0] <= 768
    assert not v4_kernel_available(generator_for("celeba", 128, arch="deep"))


def test_wrapper_rejects_targets_of_another_width(pairs):
    _, tg = pairs("celeba_wide")
    x, z0 = _inputs("celeba_wide")
    pack = pack_v4(tg)
    with pytest.raises(ValueError, match="out_dim"):
        fused_projection_v4(pack, x_rows(pack, torch.from_numpy(x))[:, :700],
                            torch.from_numpy(z0), rec_iters=1, rec_lr=LR,
                            momentum=MOM)


def test_kernel_path_raises_without_a_card(pairs, monkeypatch):
    """Off the CPU branch the wrapper goes to the kernel and nowhere else:
    with z0 on the meta device, not a CPU tensor, the call raises (it is
    not on a card) instead of falling back to the plain version; and the
    shared run_loop refuses CPU tensors, host tables among the weights or
    not."""
    _, tg = pairs("celeba_wide")
    x, z0 = _inputs("celeba_wide")
    pack = pack_v4(tg)
    xr = x_rows(pack, torch.from_numpy(x))
    called = []
    monkeypatch.setattr(v4, "v4_loop_plain", lambda *a, **k: called.append(1))
    before = build.LAUNCHES[V4]
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_projection_v4(pack, xr, torch.from_numpy(z0).to("meta"),
                            rec_iters=1, rec_lr=LR, momentum=MOM)
    assert not called
    assert build.LAUNCHES[V4] == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        run_loop(v4_state(pack), xr, torch.from_numpy(z0), rec_iters=1,
                 rec_lr=LR, momentum=MOM)


# ---- the grid conv on its own (kernels/conv3x3.py): the kernel's order of
# pixels, and the plain version the card holds the kernel against, here
# against an independent float64 convolution


@pytest.mark.parametrize("g", [4, 7, 16])
def test_pixel_order_puts_the_full_taps_first(g):
    order = pixel_order(g)
    assert order.dtype == np.int32 and sorted(order) == list(range(g * g))
    taps = tap_masks(g).sum(1)[order]
    assert list(taps) == sorted(taps, reverse=True)
    assert taps[0] == 9 and taps[-1] == 4
    # within a count, pixel order (the walk stays near the grid's rows)
    for n in (9, 6, 4):
        run = order[taps == n]
        assert list(run) == sorted(run)


def _conv_reference(inp, w, g, mode, bias=None, x=None, h=None, scale=1.0):
    """float64 F.conv2d on blocked [M, g*g*cin] rows: (result, magnitude),
    the magnitude being the same conv of |in| and |w| (a bound on the sum
    of the absolute products)."""
    m, cin, cout = inp.shape[0], w.shape[0] // 9, w.shape[1]
    a = inp.double().reshape(m, g, g, cin).permute(0, 3, 1, 2)
    k = w.double().reshape(3, 3, cin, cout)
    if mode == "backward":
        k = k.flip(0, 1)        # the input gradient: taps p - off_k
    k = k.permute(3, 2, 0, 1)
    acc = torch.nn.functional.conv2d(a, k, padding=1)
    mag = torch.nn.functional.conv2d(a.abs(), k.abs(), padding=1)

    def flat(t):
        return t.permute(0, 2, 3, 1).reshape(m, -1)
    acc, mag = flat(acc), flat(mag)
    if mode == "backward":
        return torch.where(h.double() > 0, acc, 0.0), mag
    acc = acc + bias.double().repeat(g * g)
    if mode == "tanh_grad":
        t = torch.tanh(acc)
        return (t - x.double()) * (1 - t * t) * scale, mag * scale
    return torch.relu(acc), mag


CONV_CASES = {
    # mode, g, cin, cout, in_fine, out_fine, rows
    "chain_g7": ("chain", 7, 16, 8, 0, 0, 3),
    "per_tap_g4_interleaved_out": ("per_tap", 4, 8, 16, 0, 4, 2),
    "tanh_grad_g4": ("tanh_grad", 4, 16, 12, 0, 0, 3),
    "backward_g4_interleaved_in": ("backward", 4, 16, 8, 4, 0, 2),
    "backward_g2": ("backward", 2, 8, 8, 0, 0, 5),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv3x3_plain_matches_a_float64_conv2d(case):
    """The plain conv's taps, masks, interleaves and roundings against
    F.conv2d in float64: within the bf16 rounding of the output (2^-8 of
    it) plus, for the backward, the rounding of each tap (2^-8 of the
    summed magnitudes); a misplaced tap or lane is off by the products
    themselves."""
    mode, g, cin, cout, in_fine, out_fine, m = CONV_CASES[case]
    rng = np.random.RandomState(len(case))
    bf = torch.bfloat16

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(bf)
    blocked_in = rand(m, g * g * cin)
    w = rand(9 * cin, cout)
    kw = dict(bias=torch.from_numpy(rng.randn(cout).astype(np.float32)),
              scale=0.5)
    if mode == "tanh_grad":
        kw["x"] = torch.tanh(rand(m, g * g * cout).float()).to(bf)
    if mode == "backward":
        kw = dict(h=rand(m, g * g * cout))
    got = conv3x3_plain(to_fine(blocked_in, g, in_fine), w, g, mode,
                        in_fine=in_fine, out_fine=out_fine, **kw)
    assert got.dtype == bf and tuple(got.shape) == (m, g * g * cout)
    ref, mag = _conv_reference(blocked_in, w, g, mode, **kw)
    err = (to_blocked(got, g, out_fine).double() - ref).abs()
    slack = mag * (2.0 ** -8 if mode == "backward" else 1e-6)
    assert (err <= 2.0 ** -8 * ref.abs() + slack).all(), err.max().item()
    assert ref.abs().max() > 0.5


def test_conv3x3_runs_the_plain_version_on_the_cpu():
    """On CPU tensors the wrapper is the plain version (no launch counted);
    chain and per_tap differ only in the kernel's summation order; bad
    widths and modes raise."""
    rng = np.random.RandomState(0)
    inp = torch.from_numpy(rng.randn(2, 16 * 8).astype(np.float32))
    inp = inp.to(torch.bfloat16)
    w = torch.from_numpy(rng.randn(9 * 8, 8).astype(np.float32))
    w = w.to(torch.bfloat16)
    b = torch.zeros(8)
    before = build.LAUNCHES[CONV3X3_COUNTER]
    got = conv3x3(inp, w, 4, "chain", bias=b)
    assert build.LAUNCHES[CONV3X3_COUNTER] == before
    assert torch.equal(got, conv3x3_plain(inp, w, 4, "chain", bias=b))
    assert torch.equal(got, conv3x3(inp, w, 4, "per_tap", bias=b))
    h = conv3x3(inp, w, 4, "backward", h=got)
    assert torch.equal(h, conv3x3_plain(inp, w, 4, "backward", h=got))
    with pytest.raises(ValueError, match="mode"):
        conv3x3(inp, w, 4, "sideways", bias=b)
    with pytest.raises(ValueError, match="no 3x3 conv"):
        conv3x3(inp, w, 5, "chain", bias=b)
    with pytest.raises(ValueError, match="bias"):
        conv3x3(inp, w, 4, "chain")
    with pytest.raises(ValueError, match="interleave"):
        conv3x3(inp, w, 4, "chain", bias=b, out_fine=4)


@pytest.mark.parametrize("mode", ["per_tap", "backward"])
def test_rounding_band_tells_a_flipped_rounding_from_a_misplaced_slab(mode):
    """The band the card holds the conv kernel to (conv3x3.rounding_excess):
    the plain version against itself and against itself with one bf16 ulp
    moved in a few outputs lies inside it; the same conv with one 64-deep K
    slab of one tap dropped (a misplaced slab in the kernel) lies outside,
    in the forward and in the backward (whose band also holds one ulp of
    every rounded tap)."""
    rng = np.random.RandomState(7)
    g, cin, cout, m = 4, 128, 64, 3
    bf = torch.bfloat16
    inp = torch.from_numpy(rng.randn(m, g * g * cin).astype(np.float32))
    inp = torch.relu(inp).to(bf)
    w = torch.from_numpy((rng.randn(9 * cin, cout) / np.sqrt(cin))
                         .astype(np.float32)).to(bf)
    kw = dict(h=torch.ones(m, g * g * cout, dtype=bf)) \
        if mode == "backward" else dict(bias=torch.zeros(cout))
    ref = conv3x3_plain(inp, w, g, mode, **kw)
    assert rounding_excess(ref, ref, inp, w, g, mode) <= 0
    flipped = ref.clone()
    flipped[:, :5] = (ref[:, :5].float() * (1 + 2.0 ** -7)).to(bf)
    assert rounding_excess(flipped, ref, inp, w, g, mode) <= 0
    w_bad = w.clone()
    w_bad[4 * cin:4 * cin + 64] = 0          # tap 4 (the centre), slab 0
    bad = conv3x3_plain(inp, w_bad, g, mode, **kw)
    assert rounding_excess(bad, ref, inp, w, g, mode) > 0
