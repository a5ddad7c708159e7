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

from defensegan_tpu.configs import Config as JaxConfig  # noqa: E402
from defensegan_tpu.defense.project import sample_z0  # noqa: E402
from defensegan_tpu.gan import DefenseGAN as JaxGAN  # noqa: E402
from defensegan_tpu.kernels.fused_projection_v3 import (  # noqa: E402
    pack_s2d as jax_pack)
import fused_projection_v3p_exp as jax_v3p  # noqa: E402
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
from defensegan_torch.kernels.fused_projection_v3 import (  # noqa: E402
    pack_s2d, padded_s2d, s2d_loop_plain)
from defensegan_torch.models.generator import generator_for  # noqa: E402

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
