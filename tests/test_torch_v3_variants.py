"""PyTorch port vs JAX: the three layout experiments on the deep loop v3
(defensegan_torch/experiments/: fused_projection_v3p.py, v3_packed.py,
v3_ilp.py, and the A/B of v3_variants.py).

On the CPU each variant's wrapper runs its plain version, held here
against the experiment's Pallas kernel in interpret mode (scripts/
fused_projection_v3p_exp.py, pallas_v3_packed_exp.py, pallas_v3_ilp_exp.py,
imported from scripts/), at tests/test_torch_fused_v3.py's sizes: gen_dim
4, latent 32, tile 8, L 8. As v3's, both sides round at the same points
and differ in float32 summation order: z_final within 1e-5 (v3 measured
1.2e-7 there; a misplaced tap, mask or pad pixel moves z by ~1e-2).

v3p's conv A issues only the taps whose source is a real pixel and only
the real pixels' tiles (`padded_tap_masks`, `padded_pixel_order`): v3's
361 taps a direction. Its plain version, restricted the same way, equals
the all-taps form (the TPU kernel's) bit for bit, since a skipped tap
reads only zeros; both match the Pallas kernel in interpret mode.

Against v3's own plain loop: the two-chain loop computes v3's rows, so
its plain version equals v3's bit for bit. v3p and packed each change one
rounding. v3p rounds the fc product to bf16 before the bias: where the
bias cancels most of the product, h0 moves by a bf16 ulp of the product,
not of h0 (one step of this narrow seeded model moved 9% further than
v3's), so v3p is held structurally: without that rounding its plain loop
equals v3's bit for bit over L steps (the pad pixels add exact zeros).
Packed rounds conv A's backward once after its tap sum instead of each
tap: the forward of the first step is v3's, so after one step z_final is
within one bf16 ulp (2^-8) of the step z took. A misplaced tap or pad
pixel moves the step by tens of percent.
"""

import ctypes
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "scripts"))
sys.path.insert(2, os.path.join(ROOT, "tests"))

from defensegan_tpu.configs import Config as JaxConfig  # noqa: E402
from defensegan_tpu.defense.project import sample_z0  # noqa: E402
from defensegan_tpu.gan import DefenseGAN as JaxGAN  # noqa: E402
from defensegan_tpu.kernels.fused_projection_v3 import (  # noqa: E402
    pack_s2d as jax_pack)
import fused_projection_v3p_exp as jax_v3p  # noqa: E402
import torch_kernel_profile as kprof  # noqa: E402
import pallas_v3_ilp_exp as jax_ilp  # noqa: E402
import pallas_v3_packed_exp as jax_packed  # noqa: E402
from defensegan_torch.ckpt.bridge import load_flax_tree  # noqa: E402
from defensegan_torch.configs import Config  # noqa: E402
from defensegan_torch.experiments import (  # noqa: E402
    fused_projection_v3p as v3p)
from defensegan_torch.experiments import v3_ilp, v3_packed  # noqa: E402
from defensegan_torch.experiments.v3_variants import (  # noqa: E402
    VARIANTS, ab_variant)
from defensegan_torch.gan import DefenseGAN  # noqa: E402
from defensegan_torch.kernels import build  # noqa: E402
from defensegan_torch.kernels.conv3x3 import (  # noqa: E402
    conv3x3_plain, rounding_excess)
from defensegan_torch.kernels.fused_projection_v3 import (  # noqa: E402
    pack_s2d, padded_s2d, s2d_loop_plain)
from defensegan_torch.kernels.grid import pixel_order, tap_masks  # noqa: E402
from defensegan_torch.kernels.loop import argtypes  # noqa: E402
from defensegan_torch.models.generator import generator_for  # noqa: E402
from torch_csrc_signatures import c_signatures  # noqa: E402

torch.set_num_threads(2)

L, LR, MOM, TILE = 8, 10.0, 0.7, 8


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A deep JAX DefenseGAN with non-trivial BatchNorm statistics (so the
    BN fold is not the identity) and the port's generator, same arrays
    (as tests/test_torch_fused_v3.py makes them)."""
    cfg = JaxConfig(type="mnist", gen_arch="deep", gen_dim=4, disc_dim=4,
                    latent_dim=32, rec_rr=2, rec_iters=L,
                    compute_dtype="bfloat16", projection_kernel="xla",
                    output_dir=str(tmp_path_factory.mktemp("run")))
    jgan = JaxGAN(cfg)
    rng = np.random.RandomState(0)
    stats = jax.tree.map(
        lambda a: np.asarray(a) + 0.5 * rng.rand(*a.shape).astype(np.float32),
        jgan.state.gen_stats)
    params = jax.tree.map(np.asarray, jgan.state.gen_params)
    for name in ("bn_in", "bn_0"):
        params[name]["scale"] = params[name]["scale"] + 0.3 * rng.randn(
            *params[name]["scale"].shape).astype(np.float32)
        params[name]["bias"] = 0.2 * rng.randn(
            *params[name]["bias"].shape).astype(np.float32)
    jgan.state = jgan.state.replace(gen_params=params, gen_stats=stats)
    tg = generator_for("mnist", 4, torch.bfloat16, "deep", 32)
    load_flax_tree(tg, params, stats)
    return jgan, tg.requires_grad_(False)


def _inputs(n=16, seed=0):
    rng = np.random.RandomState(seed)
    x = np.tanh(rng.randn(n, 784)).astype(np.float32)   # s2d-flat order
    z0 = rng.randn(n, 32).astype(np.float32)
    return x, z0


def _pixel_major(x, npix, tile=TILE):
    """[N, npix*16] rows -> the Pallas kernels' pixel-major rows per tile."""
    n = x.shape[0]
    x = x.reshape(n // tile, tile, npix, 16).transpose(0, 2, 1, 3)
    return x.reshape(npix * n, 16)


def _padded(x):
    """[N, 49*16] s2d-flat -> [N, 56*16] on the padded grid (the JAX
    reconstructor's real_to_pad scatter)."""
    return v3p.pad_pixels(torch.from_numpy(x), 7, 16).numpy()


def test_padded_pack_helpers_equal_jax(pair):
    jgan, tg = pair
    np.testing.assert_array_equal(v3p._pad_row_mask(7, 8),
                                  jax_v3p._pad_row_mask(7, 8))
    jp = jax_pack(jgan)
    b1 = np.asarray(jp.b1, np.float32)
    ref = np.zeros((56, b1.shape[1]), np.float32)
    for p in range(56):
        y, xx = divmod(p, 8)
        if xx < 7:
            ref[p] = b1[y * 7 + xx]
    np.testing.assert_array_equal(v3p.b1_pad(pack_s2d(tg)).numpy(), ref)
    np.testing.assert_array_equal(
        v3p.real_to_pad(7), [(p // 7) * 8 + p % 7 for p in range(49)])


@pytest.mark.parametrize("steps", [1, L])
def test_v3p_plain_loop_matches_pallas_interpret(pair, steps):
    jgan, tg = pair
    x, z0 = _inputs()
    ref = np.asarray(jax_v3p.fused_projection_s2d_padded(
        jax_pack(jgan), jnp.asarray(_pixel_major(_padded(x), 56)),
        jnp.asarray(z0), rec_iters=steps, rec_lr=LR, momentum=MOM,
        tile=TILE, interpret=True))
    before = build.LAUNCHES[v3p.COUNTER]
    got = v3p.fused_projection_s2d_padded(
        pack_s2d(tg), torch.from_numpy(x), torch.from_numpy(z0),
        rec_iters=steps, rec_lr=LR, momentum=MOM).numpy()
    assert build.LAUNCHES[v3p.COUNTER] == before     # the plain version ran
    assert np.abs(got - z0).max() > 5e-3              # the loop moved z
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("steps", [1, L])
def test_v3p_all_taps_plain_loop_matches_pallas_interpret(pair, steps):
    """The all-taps form (the TPU kernel's: every tap at every padded
    pixel) against the same Pallas kernel, within the same 1e-5."""
    jgan, tg = pair
    x, z0 = _inputs()
    ref = np.asarray(jax_v3p.fused_projection_s2d_padded(
        jax_pack(jgan), jnp.asarray(_pixel_major(_padded(x), 56)),
        jnp.asarray(z0), rec_iters=steps, rec_lr=LR, momentum=MOM,
        tile=TILE, interpret=True))
    got = v3p.s2d_padded_loop_plain(
        pack_s2d(tg), torch.from_numpy(x), torch.from_numpy(z0),
        rec_iters=steps, rec_lr=LR, momentum=MOM, counted_taps=False).numpy()
    assert np.abs(got - z0).max() > 5e-3
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("g", [3, 7])
def test_padded_masks_count_v3s_taps_at_the_real_pixels(g):
    """Each real pixel's counted taps are v3's at the same (y, x), both
    ways (the backward reads [p, 8 - k] for source p - off_k); the walk is
    the real pixels in v3's order, no pad pixel; 361 taps on 7 x 7."""
    m, order = v3p.padded_tap_masks(g), v3p.padded_pixel_order(g)
    real, gx = v3p.real_to_pad(g), g + 1
    assert m.shape == (g * gx, 9) and order.dtype == np.int32
    np.testing.assert_array_equal(m[real], tap_masks(g))
    np.testing.assert_array_equal(order, real[pixel_order(g)])
    assert not np.isin(order, np.arange(g, g * gx, gx)).any()
    assert m[order].sum() == tap_masks(g).sum()
    if g == 7:
        assert m[order].sum() == 361
    for p in range(g * gx):
        for k in range(9):
            q = p - ((k // 3 - 1) * gx + k % 3 - 1)
            assert m[p, 8 - k] == float(0 <= q < g * gx and q % gx != g)


@pytest.mark.parametrize("steps", [1, 5])
def test_v3p_counted_taps_equal_all_taps_bit_for_bit(pair, steps):
    """Zero taps add nothing: the plain loop restricted to the counted
    taps (the kernel's) equals the all-taps form bit for bit."""
    _, tg = pair
    x, z0 = _inputs(64, seed=7)
    kw = dict(rec_iters=steps, rec_lr=LR, momentum=MOM)
    pack = pack_s2d(tg)
    xt, zt = torch.from_numpy(x), torch.from_numpy(z0)
    got = v3p.s2d_padded_loop_plain(pack, xt, zt, **kw)
    ref = v3p.s2d_padded_loop_plain(pack, xt, zt, counted_taps=False, **kw)
    assert (got - zt).abs().max().item() > 5e-3
    assert torch.equal(got, ref)


def test_v3p_kernel_args_on_the_padded_grid(pair):
    """fp_v3p_run's inputs: x and the fc padded to 56 pixels, v3p's masks
    and walk, scratch per row on the padded grid; what run_loop binds
    matches the C entry's parameters."""
    _, tg = pair
    pack = pack_s2d(tg)
    x, _ = _inputs()
    state = v3p.v3p_state(pack)
    x_pad = v3p.pad_pixels(torch.from_numpy(x).to(torch.bfloat16),
                           pack.grid_hw, pack.cb)
    pp = padded_s2d(pack)
    assert tuple(x_pad.shape) == (16, 56 * pp.cb)
    assert x_pad.dtype == torch.bfloat16
    assert (state.library, state.entry, state.counter) == (
        v3p.LIBRARY, "fp_v3p_run", v3p.COUNTER)
    np.testing.assert_array_equal(state.weights[9].numpy(),
                                  v3p.padded_tap_masks(7))
    np.testing.assert_array_equal(state.weights[10].numpy(),
                                  v3p.padded_pixel_order(7))
    assert [c for c, _ in state.scratch[1:3]] == [56 * pp.c0, 56 * pp.ca]
    restype, params = c_signatures("fused_projection_v3_variants.cu")[
        "fp_v3p_run"]
    n_ptr = 3 + len(state.weights) + len(state.scratch)
    assert restype is ctypes.c_int
    assert params == [ctypes.c_void_p] * n_ptr + \
        [ctypes.c_int] * (2 + len(state.dims)) + [ctypes.c_float] * 3 + \
        [ctypes.c_void_p] == argtypes(state)


def test_conv_a_binding_matches_the_c_signature():
    entries = c_signatures("fused_projection_v3_variants.cu")
    assert entries["fp_conv_a"] == (ctypes.c_int, v3_ilp.CONV_A_ARGTYPES)
    # the loops: fp_v3_ilp_run and fp_v3_packed_run take v3's parameters
    v3 = c_signatures("fused_projection_v3.cu")["fp_v3_run"]
    assert entries["fp_v3_ilp_run"] == entries["fp_v3_packed_run"] == v3


@pytest.mark.parametrize("mode", ["chain", "backward"])
def test_conv_a_on_the_cpu_is_the_plain_conv(mode):
    """On CPU tensors conv_a runs conv3x3_plain on v3's grid, launching
    nothing; probes and other modes are refused."""
    rng = np.random.RandomState(8)
    g, cin, cout = 7, 64, 128
    inp = torch.from_numpy(rng.randn(5, g * g * cin).astype(np.float32)) \
        .to(torch.bfloat16)
    w = torch.from_numpy(0.1 * rng.randn(9 * cin, cout).astype(np.float32)) \
        .to(torch.bfloat16)
    kw = dict(bias=torch.from_numpy(rng.randn(cout).astype(np.float32))) \
        if mode == "chain" else dict(h=torch.from_numpy(rng.randn(
            5, g * g * cout).astype(np.float32)).to(torch.bfloat16))
    before = build.LAUNCHES[v3_ilp.CONV_COUNTER]
    for schedule in v3_ilp.SCHEDULES:
        got = v3_ilp.conv_a(inp, w, g, mode, schedule=schedule, **kw)
        assert torch.equal(got, conv3x3_plain(inp, w, g, mode, **kw))
    assert build.LAUNCHES[v3_ilp.CONV_COUNTER] == before
    with pytest.raises(ValueError, match="CUDA"):
        v3_ilp.conv_a(inp, w, g, mode, probe="feed", **kw)
    with pytest.raises(ValueError, match="schedule"):
        v3_ilp.conv_a(inp, w, g, mode, schedule="ilp", **kw)
    with pytest.raises(ValueError, match="conv A runs"):
        v3_ilp.conv_a(inp, w, g, "per_tap", **kw)


def test_profile_counts_v3p_conv_a_as_v3s(pair):
    """scripts/torch_kernel_profile.py: v3p's conv A issues v3's 361-tap
    operations, its GEMMs run over 56 pixels; ilp issues v3's launches;
    conv A's copies bring 80 m-tiles x 361 taps x 4 slabs of 32 KB per
    128 x 256 output (forward) or 128 x 128 (backward) at 10240 rows."""
    _, tg = pair
    pack = pack_s2d(tg)
    v3 = kprof.issued("fused_projection_v3", pack, 128, 2)
    pad = kprof.issued("fused_projection_v3p", pack, 128, 2)
    assert kprof.issued("fused_projection_v3_ilp", pack, 128, 2) == v3
    assert pad["conv A forward"] == pad["conv A backward"] == \
        v3["conv A forward"]
    back = kprof.FC_BACKWARD[0]          # K = the pixels' channels
    assert pad[back][0] * 49 == v3[back][0] * 56
    assert kprof.step_labels("fused_projection_v3p", pack) == \
        kprof.V3_LAUNCHES
    assert kprof.conv_a_bytes(10240, 7, 128, 256) == \
        kprof.conv_a_bytes(10240, 7, 256, 128) == 80 * 361 * 4 * 32768


@pytest.mark.parametrize("steps", [1, L])
def test_packed_plain_loop_matches_pallas_interpret(pair, steps):
    jgan, tg = pair
    x, z0 = _inputs()
    ref = np.asarray(jax_packed.run_packed(
        jax_pack(jgan), jnp.asarray(_pixel_major(x, 49)), jnp.asarray(z0),
        rec_iters=steps, rec_lr=LR, momentum=MOM, tile=TILE,
        interpret=True))
    before = build.LAUNCHES[v3_packed.COUNTER]
    got = v3_packed.run_packed(
        pack_s2d(tg), torch.from_numpy(x), torch.from_numpy(z0),
        rec_iters=steps, rec_lr=LR, momentum=MOM).numpy()
    assert build.LAUNCHES[v3_packed.COUNTER] == before
    assert np.abs(got - z0).max() > 5e-3
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_ilp_reconstructor_matches_pallas_interpret(pair):
    """The JAX two-subtile kernel is reached through its reconstructor,
    which draws z0 from its key: the port gets the same z0. The winning
    restarts' z_final within 1e-5, the [B, R] losses within 1e-4 (as
    tests/test_torch_fused_v3.py holds v3's reconstructor)."""
    jgan, tg = pair
    rng = np.random.RandomState(1)
    x = rng.rand(8, 28, 28, 1).astype(np.float32)
    key = jax.random.key(0)
    ref = jax_ilp.make_ilp_reconstructor(
        jgan, rec_rr=2, rec_iters=L, rec_lr=LR, momentum=MOM, tile=TILE,
        interpret=True)(jnp.asarray(x), key)
    z0 = np.array(sample_z0(key, 8, 2, 32))
    before = build.LAUNCHES[v3_ilp.COUNTER]
    got = v3_ilp.make_ilp_reconstructor(
        tg, (28, 28, 1), rec_rr=2, rec_iters=L, rec_lr=LR,
        momentum=MOM)(torch.from_numpy(x), z0=torch.from_numpy(z0))
    assert build.LAUNCHES[v3_ilp.COUNTER] == before
    np.testing.assert_allclose(got.all_losses.numpy(),
                               np.asarray(ref.all_losses), atol=1e-4)
    np.testing.assert_array_equal(got.all_losses.numpy().argmin(1),
                                  np.asarray(ref.all_losses).argmin(1))
    np.testing.assert_allclose(got.z_star.numpy(), np.asarray(ref.z_star),
                               atol=1e-5)
    assert got.x_hat.shape == (8, 28, 28, 1)


def test_v3p_reconstructor_matches_pallas_interpret(pair):
    jgan, tg = pair
    rng = np.random.RandomState(2)
    x = rng.rand(8, 28, 28, 1).astype(np.float32)
    key = jax.random.key(3)
    ref = jax_v3p.make_pallas_s2d_padded_reconstructor(
        jgan, rec_rr=2, rec_iters=L, rec_lr=LR, momentum=MOM, tile=TILE,
        interpret=True)(jnp.asarray(x), key)
    z0 = np.array(sample_z0(key, 8, 2, 32))
    got = v3p.make_s2d_padded_reconstructor(
        tg, (28, 28, 1), rec_rr=2, rec_iters=L, rec_lr=LR,
        momentum=MOM)(torch.from_numpy(x), z0=torch.from_numpy(z0))
    np.testing.assert_allclose(got.all_losses.numpy(),
                               np.asarray(ref.all_losses), atol=1e-4)
    np.testing.assert_allclose(got.z_star.numpy(), np.asarray(ref.z_star),
                               atol=1e-5)


@pytest.mark.parametrize("n", [16, 160])
def test_ilp_plain_loop_is_v3_bit_for_bit(pair, n):
    """Two chains of v3's rows (160 rows: 128 + 32) are v3's loop."""
    _, tg = pair
    x, z0 = _inputs(n, seed=4)
    kw = dict(rec_iters=3, rec_lr=LR, momentum=MOM)
    pack = pack_s2d(tg)
    got = v3_ilp.ilp_loop_plain(pack, torch.from_numpy(x),
                                torch.from_numpy(z0), **kw)
    ref = s2d_loop_plain(pack, torch.from_numpy(x), torch.from_numpy(z0),
                         **kw)
    assert torch.equal(got, ref)


def test_packed_rounding_moves_one_step_by_at_most_an_ulp(pair):
    _, tg = pair
    x, z0 = _inputs(64, seed=5)
    kw = dict(rec_iters=1, rec_lr=LR, momentum=MOM)
    pack = pack_s2d(tg)
    xt, zt = torch.from_numpy(x), torch.from_numpy(z0)
    ref = s2d_loop_plain(pack, xt, zt, **kw)
    got = v3_packed.packed_loop_plain(pack, xt, zt, **kw)
    step = (ref - zt).abs().max().item()
    diff = (got - ref).abs().max().item()
    assert 0.0 < diff <= 2.0 ** -8 * step, (diff, step)


def test_v3p_without_its_rounding_change_is_v3_bit_for_bit(pair):
    _, tg = pair
    x, z0 = _inputs(64, seed=5)
    kw = dict(rec_iters=L, rec_lr=LR, momentum=MOM)
    pack = pack_s2d(tg)
    xt, zt = torch.from_numpy(x), torch.from_numpy(z0)
    ref = s2d_loop_plain(pack, xt, zt, **kw)
    assert torch.equal(
        v3p.s2d_padded_loop_plain(pack, xt, zt, round_fc=False, **kw), ref)
    assert not torch.equal(v3p.s2d_padded_loop_plain(pack, xt, zt, **kw),
                           ref)


def test_padded_plain_loop_takes_the_kernel_pack(pair):
    """The v3p plain loop on the pack padded to the kernel's tile widths
    computes the same function (1e-6: longer sums in another order) and
    keeps the padded latents at zero."""
    _, tg = pair
    pack = pack_s2d(tg)
    x, z0 = _inputs(seed=6)
    kw = dict(rec_iters=3, rec_lr=LR, momentum=MOM)
    ref = v3p.s2d_padded_loop_plain(pack, torch.from_numpy(x),
                                    torch.from_numpy(z0), **kw)
    z0p = torch.zeros(16, 64)
    z0p[:, :32] = torch.from_numpy(z0)
    got = v3p.s2d_padded_loop_plain(padded_s2d(pack), torch.from_numpy(x),
                                    z0p, **kw)
    assert torch.equal(got[:, 32:], torch.zeros(16, 32))
    np.testing.assert_allclose(got[:, :32].numpy(), ref.numpy(), atol=1e-6)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_wrappers_reject_targets_of_another_width(pair, variant):
    _, tg = pair
    x, z0 = _inputs()
    with pytest.raises(ValueError, match="out_dim"):
        VARIANTS[variant].loop(pack_s2d(tg), torch.from_numpy(x[:, :700]),
                               torch.from_numpy(z0), rec_iters=1, rec_lr=LR,
                               momentum=MOM)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_ab_harness_on_the_cpu(variant):
    """The A/B on a narrow deep model on the CPU (the plain versions):
    the gate passes, ilp bit for bit, and both sides are timed."""
    cfg = Config(type="mnist", gen_arch="deep", gen_dim=4, latent_dim=32,
                 rec_rr=2, rec_iters=4)
    gan = DefenseGAN(cfg, device="cpu")
    rec = ab_variant(gan, variant, batch=8, repeats=1)
    assert rec["gate"]["ok"], rec["gate"]
    if variant == "ilp":
        assert rec["gate"]["z_final_bit_equal"]
    assert rec["v3"]["recon_per_s"] > 0 and rec[variant]["recon_per_s"] > 0
    assert rec["rows"] == 16


def test_packed_entries_take_v3s_parameters():
    """fp_v3_packed_run (the fused conv B section) and the three-launch
    form it is held against on the card take fp_v3_run's parameters;
    the fused wrapper allocates no packed product or packed do."""
    entries = c_signatures("fused_projection_v3_variants.cu")
    v3 = c_signatures("fused_projection_v3.cu")["fp_v3_run"]
    assert entries["fp_v3_packed_launches_run"] == \
        entries["fp_v3_packed_run"] == v3
    assert v3_packed.FUSED_CONV_B


def test_packed_three_launch_form_on_the_cpu_is_the_plain_loop(pair):
    """On CPU tensors both forms of the packed loop are its plain version,
    launching nothing."""
    _, tg = pair
    x, z0 = _inputs(16, seed=7)
    kw = dict(rec_iters=2, rec_lr=LR, momentum=MOM)
    pack = pack_s2d(tg)
    xt, zt = torch.from_numpy(x), torch.from_numpy(z0)
    before = build.LAUNCHES[v3_packed.COUNTER]
    fused = v3_packed.run_packed(pack, xt, zt, **kw)
    three = v3_packed.run_packed(pack, xt, zt, fused=False, **kw)
    assert build.LAUNCHES[v3_packed.COUNTER] == before
    assert torch.equal(fused, three)
    assert torch.equal(fused, v3_packed.packed_loop_plain(pack, xt, zt, **kw))


def test_conv_a_chained_backward_on_the_cpu():
    """conv_a's backward_chain on CPU tensors: the taps' float32 sum
    rounded once, masked by h > 0; within one bf16 ulp of each rounded
    tap of the per-tap backward, and not equal to it."""
    rng = np.random.RandomState(9)
    g, cin, cout = 7, 128, 64
    inp = torch.from_numpy(rng.randn(6, g * g * cin).astype(np.float32)) \
        .to(torch.bfloat16)
    w = torch.from_numpy(0.1 * rng.randn(9 * cin, cout).astype(np.float32)) \
        .to(torch.bfloat16)
    h = torch.from_numpy(rng.randn(6, g * g * cout).astype(np.float32)) \
        .to(torch.bfloat16)
    before = build.LAUNCHES[v3_ilp.CONV_COUNTER]
    got = v3_ilp.conv_a(inp, w, g, "backward_chain", h=h)
    assert build.LAUNCHES[v3_ilp.CONV_COUNTER] == before
    per_tap = conv3x3_plain(inp, w, g, "backward", h=h)
    assert not torch.equal(got, per_tap)
    assert (got[h.float() <= 0.0] == 0).all()         # masked by h > 0
    assert rounding_excess(got, per_tap, inp, w, g, "backward") <= 0.0
    assert v3_ilp.CONV_A_MODES.index("backward_chain") == 2


def test_profile_counts_packed_as_one_section_launch(pair):
    """scripts/torch_kernel_profile.py: the packed loop's step names its
    fused conv B section as one launch issuing a latent's 64-row tile, N
    144 forward and K 144 backward; the other launches as v3's."""
    _, tg = pair
    pack = pack_s2d(tg)
    assert kprof.step_labels(kprof.PACKED, pack) == kprof.PACKED_LAUNCHES
    ops = kprof.issued(kprof.PACKED, pack, 128, 2)
    v3 = kprof.issued("fused_projection_v3", pack, 128, 2)
    pp = padded_s2d(pack)
    assert ops[kprof.PACKED_LAUNCHES[2]][0] == \
        2.0 * 2 * 128 * 2 * 64 * pp.ca * 144
    for label in kprof.PACKED_LAUNCHES:
        if label != kprof.PACKED_LAUNCHES[2]:
            assert ops.get(label) == v3.get(label)


def test_profile_names_v3s_launches_by_its_entry(pair):
    """scripts/torch_kernel_profile.py: v3's step on a pack whose conv B
    section fuses (the deep MNIST generator) is packed's five launches;
    on one it does not (ca 512), v3's seven."""
    _, tg = pair
    assert kprof.step_labels("fused_projection_v3", pack_s2d(tg)) == \
        kprof.PACKED_LAUNCHES
    wide = generator_for("mnist", 128, torch.bfloat16, "deep", 32)
    assert kprof.step_labels("fused_projection_v3", pack_s2d(
        wide.requires_grad_(False))) == kprof.V3_LAUNCHES


def test_profile_counts_stream64_slabs():
    """--kernel stream64's issued slabs: every block by the closed form,
    the skip by stream64_probe.issued_slabs, per 128-image m-tile; and
    the script refuses to run without a card."""
    from defensegan_torch.experiments import stream64_probe as sp
    for level, (g, ci, co) in sp.LEVELS.items():
        a = sp.draw_arrays(level, 2)
        pack = sp.level_tensors(*sp.pack_level(a["w"], a["b"], a["scale"],
                                               a["shift"]), g, "cpu")
        every = kprof.stream64_slabs(sp, pack, 512, pack.bn, False)
        skip = kprof.stream64_slabs(sp, pack, 512, pack.bn, True)
        for way, backward in (("forward", False), ("backward", True)):
            assert every[way][0] == 4 * sp.issued_slabs(
                None, g, ci, 4 * co, pack.bn, backward).sum()
            assert skip[way][0] == 4 * sp.issued_slabs(
                pack.zero.numpy(), g, ci, 4 * co, pack.bn, backward).sum()
            assert skip[way][1] == every[way][1]
    if not torch.cuda.is_available():
        assert kprof.main(["--kernel", "stream64"]) == 2
        assert kprof.main(["--kernel", "packed", "--root", ROOT]) == 2



class _Window:
    """A torch.profiler window that holds the given kernel records."""

    def __init__(self, names):
        from types import SimpleNamespace
        from torch.autograd import DeviceType
        self._events = [SimpleNamespace(
            name=n, device_type=DeviceType.CUDA,
            time_range=SimpleNamespace(elapsed_us=lambda: 1000.0))
            for n in names]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return self._events

def test_profile_windows_again_when_the_profiler_drops_records(
        monkeypatch):
    """scripts/torch_kernel_profile.py::_launch_ms: a window short of a
    label's `reps` records is profiled again (up to PROFILE_WINDOWS); a
    window with every record is kept; the last window comes back when
    none has them all, for the caller to refuse."""
    import torch.profiler
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    runs = []
    label = {"conv3x3_sm90<fwd>": "forward", "conv3x3_sm90<bwd>": "backward"}

    def windows(counts):
        it = iter(counts)
        monkeypatch.setattr(torch.profiler, "profile", lambda **kw: _Window(
            ["conv3x3_sm90<fwd>"] * next(it)[0]
            + ["conv3x3_sm90<bwd>"] * 10 + ["other"]))

    windows([(7, 10), (10, 10), (3, 10)])
    got = kprof._launch_ms(lambda: runs.append(1), 10, label.get,
                           ("forward", "backward"))
    assert {k: len(v) for k, v in got.items()} == {"forward": 10,
                                                    "backward": 10}
    assert got["forward"][0] == 1.0 and len(runs) == 1 + 2 * 10
    windows([(7, 10)] * kprof.PROFILE_WINDOWS)
    runs.clear()
    got = kprof._launch_ms(lambda: runs.append(1), 10, label.get,
                           ("forward", "backward"))
    assert len(got["forward"]) == 7
    assert len(runs) == 1 + kprof.PROFILE_WINDOWS * 10
