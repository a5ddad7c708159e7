"""PyTorch port vs JAX: fused projection v2 (defensegan_torch/kernels/
fused_projection_v2.py).

On the CPU the wrapper runs the kernel's plain version; it is held against
the Pallas kernel in interpret mode (gen_dim 4, latent 32, L 8, tile 8, as
tests/test_fused_projection_v2.py runs it). Both round to bf16 at the
same points and accumulate in float32, in different orders: z_final
agrees to 1e-5 (f32 sums ~1e-7 apart, carried through 8 steps; a flipped
bf16 rounding would show as ~1e-3). The CUDA kernel itself is held
against the same plain version on the card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.configs import Config as JaxConfig
from defensegan_tpu.gan import DefenseGAN as JaxGAN
from defensegan_tpu.kernels.fused_projection_v2 import (
    fused_projection_dense as jax_fused, make_pallas_dense_reconstructor,
    pack_dense as jax_pack)
from defensegan_torch.ckpt.bridge import load_flax_tree
from defensegan_torch.kernels import build
from defensegan_torch.kernels.fused_projection_v2 import (
    dense_kernel_available, fused_projection_dense,
    make_dense_reconstructor, pack_dense)
from defensegan_torch.models.generator import generator_for

torch.set_num_threads(2)

L, LR, MOM = 8, 10.0, 0.7


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cfg = JaxConfig(type="mnist", gen_arch="wide", gen_dim=4, disc_dim=4,
                    latent_dim=32, rec_rr=2, rec_iters=L,
                    compute_dtype="bfloat16",
                    output_dir=str(tmp_path_factory.mktemp("run")))
    jgan = JaxGAN(cfg)
    tg = generator_for("mnist", 4, torch.bfloat16, "wide", 32)
    load_flax_tree(tg, jax.tree.map(np.asarray, jgan.state.gen_params),
                   jax.tree.map(np.asarray, jgan.state.gen_stats))
    return jgan, tg.requires_grad_(False)


def _inputs(n=16, seed=0):
    rng = np.random.RandomState(seed)
    x = np.tanh(rng.randn(n, 784)).astype(np.float32)
    z0 = rng.randn(n, 32).astype(np.float32)
    return x, z0


def crop_to_port(name, ref, p):
    """JAX's pack pads the output to 896 (128 lanes), the port's to 832
    (the CUDA kernel's 64-wide tile): crop JAX's [.., P] fields to the
    port's P after checking that what is cut is zero padding."""
    axis = {"d": 1, "bd": 1, "dt": 0, "dq": 1, "sd": 1, "dtq": 0}.get(name)
    if axis is None:
        return ref
    cut = np.take(ref, np.arange(p, ref.shape[axis]), axis=axis)
    assert (cut == (1 if name == "sd" else 0)).all(), name
    return np.take(ref, np.arange(p), axis=axis)


def test_pack_equals_jax(pair):
    jgan, tg = pair
    jp, tp = jax_pack(jgan), pack_dense(tg)
    assert tp.out_dim == jp.out_dim == 784 and tp.z_dim == 32
    assert tp.d.shape[1] == 832 and tp.d.dtype == torch.bfloat16
    for f in ("w1", "w1t", "b1", "d", "dt", "bd"):
        got = getattr(tp, f)
        ref = crop_to_port(f, np.asarray(getattr(jp, f), np.float32), 832)
        assert tuple(got.shape) == ref.shape, f
        np.testing.assert_array_equal(got.float().numpy(), ref, err_msg=f)


@pytest.mark.parametrize("steps", [1, L])
def test_plain_loop_matches_pallas_interpret(pair, steps):
    jgan, tg = pair
    x, z0 = _inputs()
    ref = np.asarray(jax_fused(jax_pack(jgan), jnp.asarray(x),
                               jnp.asarray(z0), rec_iters=steps, rec_lr=LR,
                               momentum=MOM, tile=8, interpret=True))
    before = build.LAUNCHES["fused_projection_v2"]
    got = fused_projection_dense(pack_dense(tg), torch.from_numpy(x),
                                 torch.from_numpy(z0), rec_iters=steps,
                                 rec_lr=LR, momentum=MOM).numpy()
    # the CPU path is the plain version: no kernel launch is counted
    assert build.LAUNCHES["fused_projection_v2"] == before
    assert np.abs(got - z0).max() > 0.1       # the loop moved z
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_reconstructor_matches_pallas_interpret(pair):
    """Epilogue included: same x and z0 -> the same [B, R] final losses,
    argmins and x_hat. Loss tolerance 1e-4: the epilogue's images are
    bf16, and a z_final ~1e-6 apart flips a pixel's rounding now and then
    (one flip moves the 784-pixel mean by ~5e-6)."""
    jgan, tg = pair
    rng = np.random.RandomState(1)
    x = rng.rand(8, 28, 28, 1).astype(np.float32)
    z0 = rng.randn(8, 2, 32).astype(np.float32)
    ref = make_pallas_dense_reconstructor(
        jgan, rec_rr=2, rec_iters=L, rec_lr=LR, momentum=MOM, tile=8,
        interpret=True)(jnp.asarray(x), jax.random.key(0), jnp.asarray(z0))
    got = make_dense_reconstructor(
        tg, (28, 28, 1), rec_rr=2, rec_iters=L, rec_lr=LR,
        momentum=MOM)(torch.from_numpy(x), z0=torch.from_numpy(z0))
    np.testing.assert_allclose(got.all_losses.numpy(),
                               np.asarray(ref.all_losses), atol=1e-4)
    np.testing.assert_array_equal(got.all_losses.numpy().argmin(1),
                                  np.asarray(ref.all_losses).argmin(1))
    np.testing.assert_allclose(got.x_hat.numpy(), np.asarray(ref.x_hat),
                               atol=1e-2)
    assert got.x_hat.shape == (8, 28, 28, 1)


def test_fp32_pack_runs_unrounded(pair):
    """dtype=float32 packs the same weights unrounded: the fp32 plain
    path, which must differ from the bf16 loop by bf16-sized amounts."""
    _, tg = pair
    x, z0 = _inputs(seed=2)
    p32, p16 = pack_dense(tg, torch.float32), pack_dense(tg)
    assert p32.w1.dtype == torch.float32
    a = fused_projection_dense(p32, torch.from_numpy(x),
                               torch.from_numpy(z0), rec_iters=3, rec_lr=LR,
                               momentum=MOM)
    b = fused_projection_dense(p16, torch.from_numpy(x),
                               torch.from_numpy(z0), rec_iters=3, rec_lr=LR,
                               momentum=MOM)
    diff = (a - b).abs().max().item()
    assert 0.0 < diff < 0.1


def test_wrapper_rejects_targets_of_another_width(pair):
    _, tg = pair
    x, z0 = _inputs()
    with pytest.raises(ValueError, match="out_dim"):
        fused_projection_dense(pack_dense(tg), torch.from_numpy(x[:, :700]),
                               torch.from_numpy(z0), rec_iters=1, rec_lr=LR,
                               momentum=MOM)


def test_dense_kernel_available():
    assert dense_kernel_available(generator_for("mnist", 4, arch="wide"))
    assert dense_kernel_available(generator_for("mnist", 16, arch="wide"))
    assert not dense_kernel_available(generator_for("mnist", 4,
                                                    arch="deep"))
    assert not dense_kernel_available(generator_for("celeba", 4,
                                                    arch="wide"))
