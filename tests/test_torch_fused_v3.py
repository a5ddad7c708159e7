"""PyTorch port vs JAX: fused projection v3, the deep two-deconv loop
(defensegan_torch/kernels/fused_projection_v3.py).

On the CPU the wrapper runs the kernel's plain version; it is held against
the Pallas kernel in interpret mode (gen_dim 4, latent 32, tile 8, as
tests/test_fused_projection_v3.py runs it). The port keeps every bf16
rounding of the TPU kernel (the two layout artefacts included), so both
sides round at the same points and differ only in float32 summation order:
z_final agrees to 1e-5 (measured 1.2e-7 at L = 8, where z moves by 0.19;
a flipped bf16 rounding of one intermediate would move z by ~1e-6, a
misplaced tap or mask by ~1e-2). The CUDA kernel itself is held against the same plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import ctypes
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.configs import Config as JaxConfig
from defensegan_tpu.gan import DefenseGAN as JaxGAN
from defensegan_tpu.kernels.fused_projection_v3 import (
    fused_projection_s2d as jax_fused, make_pallas_s2d_reconstructor,
    pack_s2d as jax_pack)
from defensegan_torch.ckpt.bridge import load_flax_tree
from defensegan_torch.kernels import build
from defensegan_torch.kernels import fused_projection_v3 as v3
from defensegan_torch.kernels.fused_projection_v3 import (
    fused_projection_s2d, make_s2d_reconstructor, pack_s2d, padded_s2d,
    s2d_kernel_available, s2d_loop_plain, s2d_state)
from defensegan_torch.kernels.grid import tap_masks
from defensegan_torch.kernels.loop import argtypes, run_loop
from defensegan_torch.models.generator import Generator, generator_for

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from torch_csrc_signatures import c_signatures  # noqa: E402

torch.set_num_threads(2)

L, LR, MOM, TILE = 8, 10.0, 0.7, 8
FIELDS = ("w1", "w1t", "b1", "ka", "kat", "ba", "kbp", "kbpt", "bb", "masks")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A deep JAX DefenseGAN with non-trivial BatchNorm statistics (so the
    BN fold is not the identity) and the port's generator, same arrays."""
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


def _pixel_major(x_s2d, tile=TILE):
    """[N, 49*cb] s2d-flat rows -> the Pallas kernel's pixel-major rows
    per tile (make_pallas_s2d_reconstructor's transform)."""
    n = x_s2d.shape[0]
    x = x_s2d.reshape(n // tile, tile, 49, 16).transpose(0, 2, 1, 3)
    return x.reshape(49 * n, 16)


def test_pack_equals_jax(pair):
    jgan, tg = pair
    jp, tp = jax_pack(jgan), pack_s2d(tg)
    assert (tp.c0, tp.ca, tp.cb, tp.grid_hw, tp.z_dim) == \
        (jp.c0, jp.ca, jp.cb, jp.grid_hw, jp.z_dim) == (8, 16, 16, 7, 32)
    for f in FIELDS:
        got, ref = getattr(tp, f), np.asarray(getattr(jp, f), np.float32)
        assert tuple(got.shape) == ref.shape, f
        assert got.dtype == (torch.float32 if f in ("b1", "ba", "bb", "masks")
                             else torch.bfloat16), f
        np.testing.assert_array_equal(got.float().numpy(), ref, err_msg=f)
    np.testing.assert_array_equal(tp.masks.numpy(), tap_masks(7))


@pytest.mark.parametrize("steps", [1, L])
def test_plain_loop_matches_pallas_interpret(pair, steps):
    jgan, tg = pair
    x, z0 = _inputs()
    ref = np.asarray(jax_fused(jax_pack(jgan), jnp.asarray(_pixel_major(x)),
                               jnp.asarray(z0), rec_iters=steps, rec_lr=LR,
                               momentum=MOM, tile=TILE, interpret=True))
    before = build.LAUNCHES["fused_projection_v3"]
    got = fused_projection_s2d(pack_s2d(tg), torch.from_numpy(x),
                               torch.from_numpy(z0), rec_iters=steps,
                               rec_lr=LR, momentum=MOM).numpy()
    # the CPU path is the plain version: no kernel launch is counted
    assert build.LAUNCHES["fused_projection_v3"] == before
    moved = np.abs(got - z0).max()
    assert moved > 5e-3                       # the loop moved z
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_reconstructor_matches_pallas_interpret(pair):
    """Epilogue included: same x and injected z0 -> the same [B, R] final
    losses, argmins and x_hat in image order. Loss tolerance 1e-4: the
    epilogue's images are bf16, and a z_final ~1e-6 apart flips a pixel's
    rounding now and then (one flip moves the 784-pixel mean by ~5e-6);
    x_hat within 1e-2 (a few bf16 ulps of a [0, 1] pixel)."""
    jgan, tg = pair
    rng = np.random.RandomState(1)
    x = rng.rand(8, 28, 28, 1).astype(np.float32)
    z0 = rng.randn(8, 2, 32).astype(np.float32)
    ref = make_pallas_s2d_reconstructor(
        jgan, rec_rr=2, rec_iters=L, rec_lr=LR, momentum=MOM, tile=TILE,
        interpret=True)(jnp.asarray(x), jax.random.key(0), jnp.asarray(z0))
    got = make_s2d_reconstructor(
        tg, (28, 28, 1), rec_rr=2, rec_iters=L, rec_lr=LR,
        momentum=MOM)(torch.from_numpy(x), z0=torch.from_numpy(z0))
    np.testing.assert_allclose(got.all_losses.numpy(),
                               np.asarray(ref.all_losses), atol=1e-4)
    np.testing.assert_array_equal(got.all_losses.numpy().argmin(1),
                                  np.asarray(ref.all_losses).argmin(1))
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(ref.loss),
                               atol=1e-4)
    np.testing.assert_allclose(got.z_star.numpy(), np.asarray(ref.z_star),
                               atol=1e-5)
    np.testing.assert_allclose(got.x_hat.numpy(), np.asarray(ref.x_hat),
                               atol=1e-2)
    assert got.x_hat.shape == (8, 28, 28, 1)


def test_padded_pack_computes_the_same_loop(pair):
    """The CUDA wrapper pads k, c0, ca and the packed conv-B widths to the
    kernel's tiles; zero rows and columns must not change the function:
    the plain loop on the padded pack equals the unpadded one on the true
    latents (1e-6: the longer sums may be taken in another order) and
    keeps the padded ones at exactly zero."""
    _, tg = pair
    pack = pack_s2d(tg)
    pp = padded_s2d(pack)
    assert (pp.z_dim, pp.c0, pp.ca, pp.cb) == (64, 64, 64, 16)
    assert tuple(pp.w1.shape) == (64, 49 * 64)
    assert tuple(pp.w1t.shape) == (49 * 64, 64)
    assert tuple(pp.ka.shape) == (9 * 64, 64)
    assert tuple(pp.kat.shape) == (9 * 64, 64)
    assert tuple(pp.kbp.shape) == (64, 192)
    assert tuple(pp.kbpt.shape) == (160, 64)
    x, z0 = _inputs(seed=3)
    kw = dict(rec_iters=3, rec_lr=LR, momentum=MOM)
    ref = s2d_loop_plain(pack, torch.from_numpy(x), torch.from_numpy(z0),
                         **kw)
    z0p = torch.zeros(16, 64)
    z0p[:, :32] = torch.from_numpy(z0)
    got = s2d_loop_plain(pp, torch.from_numpy(x), z0p, **kw)
    assert torch.equal(got[:, 32:], torch.zeros(16, 32))
    np.testing.assert_allclose(got[:, :32].numpy(), ref.numpy(), atol=1e-6)
    # the reference widths need no channel padding
    full = padded_s2d(pack_s2d(generator_for("mnist", 64, torch.bfloat16,
                                             "deep", 128)))
    assert (full.z_dim, full.c0, full.ca) == (128, 128, 256)
    assert tuple(full.kbp.shape) == (256, 192)
    assert (full.kbp[:, 144:] == 0).all() and (full.kbpt[144:] == 0).all()


def test_wrapper_rejects_targets_of_another_width(pair):
    _, tg = pair
    x, z0 = _inputs()
    with pytest.raises(ValueError, match="out_dim"):
        fused_projection_s2d(pack_s2d(tg), torch.from_numpy(x[:, :700]),
                             torch.from_numpy(z0), rec_iters=1, rec_lr=LR,
                             momentum=MOM)


def test_kernel_path_raises_without_a_card(pair, monkeypatch):
    """Off the CPU branch the wrapper goes to the kernel and nowhere else:
    with z0 on the meta device, not a CPU tensor, the call raises (it is
    not on a card) instead of falling back to the plain version; and the
    shared run_loop refuses CPU tensors."""
    _, tg = pair
    x, z0 = _inputs()
    pack = pack_s2d(tg)
    called = []
    monkeypatch.setattr(v3, "s2d_loop_plain",
                        lambda *a, **k: called.append(1))
    keys = (v3.LIBRARY, v3.FUSED_COUNTER)       # v3's two entries
    before = [build.LAUNCHES[key] for key in keys]
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_projection_s2d(pack, torch.from_numpy(x),
                             torch.from_numpy(z0).to("meta"), rec_iters=1,
                             rec_lr=LR, momentum=MOM)
    assert not called
    assert [build.LAUNCHES[key] for key in keys] == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        run_loop(s2d_state(pack), torch.from_numpy(x), torch.from_numpy(z0),
                 rec_iters=1, rec_lr=LR, momentum=MOM)


def test_s2d_kernel_available():
    assert s2d_kernel_available(generator_for("mnist", 4, arch="deep"))
    assert s2d_kernel_available(generator_for("mnist", 64, arch="deep"))
    assert not s2d_kernel_available(generator_for("mnist", 4, arch="wide"))
    assert not s2d_kernel_available(generator_for("celeba", 4, arch="deep"))
    assert not s2d_kernel_available(generator_for("mnist", 256,
                                                  arch="deep"))


# generators by the conv B section they have: (maker's arguments, fused)
SECTIONS = {
    "mnist": (("mnist", 64, "deep", 128), True),           # ca 256, cb 16
    "mnist_narrow": (("mnist", 4, "deep", 32), True),      # ca 16 -> 64
    "rgb": ((7, (128, 64), 3, 32), False),                 # cb 48
    "mnist_wide_ca": (("mnist", 128, "deep", 32), False),  # ca 512
}


def _section_generator(name):
    args, _ = SECTIONS[name]
    if isinstance(args[0], int):
        base, channels, out, latent = args
        gen = Generator(base_hw=base, channels=channels, out_channels=out,
                        latent_dim=latent, dtype=torch.bfloat16)
    else:
        data, dim, arch, latent = args
        gen = generator_for(data, dim, torch.bfloat16, arch, latent)
    return gen.requires_grad_(False)


@pytest.mark.parametrize("name", sorted(SECTIONS))
def test_s2d_state_fuses_conv_b_where_the_shapes_fit(name):
    """v3's state takes the fused conv B section (fp_v3_fused_run, its own
    counter, no packed product or packed do allocated) where the section's
    shapes fit (cb 16, g*g <= 64, ca up to 256: mnist's deep generator),
    and the three-launch entry with both scratch buffers elsewhere (a
    3-channel output's cb 48, channels[1] 128's ca 512)."""
    gen = _section_generator(name)
    assert s2d_kernel_available(gen)
    pack = pack_s2d(gen)
    pp = padded_s2d(pack)
    state = s2d_state(pack)
    fused = SECTIONS[name][1]
    assert v3.conv_b_fuses(pp) == fused
    p2 = pack.grid_hw ** 2
    packed_cols = [cols for cols, _ in state.scratch[3:5]]
    if fused:
        assert (state.entry, state.counter) == (v3.FUSED_ENTRY,
                                                v3.FUSED_COUNTER)
        assert packed_cols == [0, 0]
    else:
        assert (state.entry, state.counter) == (v3.ENTRY, None)
        assert packed_cols == [p2 * pp.kbp.shape[1], p2 * pp.kbpt.shape[0]]
    # the three-launch entry on request, whatever the shapes
    three = s2d_state(pack, entry=v3.ENTRY)
    assert three.counter is None and [cols for cols, _ in three.scratch] \
        == [pp.z_dim, p2 * pp.c0, p2 * pp.ca, p2 * pp.kbp.shape[1],
            p2 * pp.kbpt.shape[0], three.scratch[5][0]]
    assert state.dims == three.dims and state.library == three.library


def test_v3_entries_take_one_parameter_list():
    """fp_v3_fused_run takes fp_v3_run's parameters, and both bind to the
    argument list of the state that names them."""
    entries = c_signatures("fused_projection_v3.cu")
    assert entries[v3.FUSED_ENTRY] == entries[v3.ENTRY]
    pack = pack_s2d(_section_generator("mnist"))
    for state in (s2d_state(pack), s2d_state(pack, entry=v3.ENTRY)):
        restype, params = entries[state.entry]
        assert restype is ctypes.c_int and params == argtypes(state)
