"""PyTorch port vs JAX: fused projection v2i, the int8 loop
(defensegan_torch/kernels/fused_projection_v2i.py).

The int8 pack is numpy host arithmetic on equal bf16 D matrices, so it
must equal JAX's pack_dense_int8 BIT FOR BIT (on the port's 832 output
columns; JAX's further columns are zero padding); the row quantizer likewise
on equal inputs. The plain loop (CPU path of the wrapper) is held against
the Pallas kernel in interpret mode at gen_dim 4, latent 32, L 8, tile 8:
the int8 products are exact on both sides and the rest rounds at the same
points. After one step z_final agrees to 1e-5 (float32 summation order of
the bf16 z-side products); over 8 steps such a difference now and then
moves a value across a rint half-way point, changing one int8 code by 1
(1/127 of its row's scale), so the bound after L steps is 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.configs import Config as JaxConfig
from defensegan_tpu.gan import DefenseGAN as JaxGAN
from defensegan_tpu.kernels import fused_projection_v2i as jv2i
from defensegan_torch.ckpt.bridge import load_flax_tree
from defensegan_torch.kernels import build
from defensegan_torch.kernels.fused_projection_v2i import (
    _quant_cols, _quant_rows, fused_projection_dense_int8,
    make_dense_int8_reconstructor, pack_dense_int8)
from defensegan_torch.models.generator import generator_for
from test_torch_fused_v2 import crop_to_port

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


def test_int8_pack_bitwise_equals_jax(pair):
    jgan, tg = pair
    jp, tp = jv2i.pack_dense_int8(jgan), pack_dense_int8(tg)
    for f in ("dq", "sd", "dtq", "sdt"):
        got = getattr(tp, f).numpy()
        ref = crop_to_port(f, np.asarray(getattr(jp, f)), 832)
        assert got.dtype == ref.dtype and got.shape == ref.shape, f
        np.testing.assert_array_equal(got, ref, err_msg=f)
    # the zero padding columns 784..831 of D quantize to 0 with scale 1
    assert (tp.dq[:, 784:] == 0).all() and (tp.sd[0, 784:] == 1.0).all()


def test_quant_cols_and_rows_match_jax():
    rng = np.random.RandomState(0)
    w = rng.randn(64, 24).astype(np.float32)
    w[:, 3] = 0.0
    q, s = _quant_cols(w)
    qj, sj = jv2i._quant_cols(w)
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(s, sj)
    a = rng.randn(16, 40).astype(np.float32) * 3.0
    a[2] = 0.0                                  # the amax guard row
    a[5, :2] = [127.0 / 254.0, -127.0 * 3.5 / 254.0]   # half-way cases
    qr, sr = _quant_rows(torch.from_numpy(a))
    qrj, srj = jv2i._quant_rows(jnp.asarray(a))
    np.testing.assert_array_equal(qr.numpy(), np.asarray(qrj))
    np.testing.assert_array_equal(sr.numpy(), np.asarray(srj))
    assert qr.dtype == torch.int8 and int(qr.abs().max()) == 127


@pytest.mark.parametrize("steps", [1, L])
def test_plain_loop_matches_pallas_interpret(pair, steps):
    jgan, tg = pair
    rng = np.random.RandomState(1)
    x = np.tanh(rng.randn(16, 784)).astype(np.float32)
    z0 = rng.randn(16, 32).astype(np.float32)
    ref = np.asarray(jv2i.fused_projection_dense_int8(
        jv2i.pack_dense_int8(jgan), jnp.asarray(x), jnp.asarray(z0),
        rec_iters=steps, rec_lr=LR, momentum=MOM, tile=8, interpret=True))
    before = build.LAUNCHES["fused_projection_v2i"]
    got = fused_projection_dense_int8(
        pack_dense_int8(tg), torch.from_numpy(x), torch.from_numpy(z0),
        rec_iters=steps, rec_lr=LR, momentum=MOM).numpy()
    assert build.LAUNCHES["fused_projection_v2i"] == before
    assert np.abs(got - z0).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-5 if steps == 1 else 1e-3)


def test_reconstructor_matches_pallas_interpret(pair):
    """Epilogue included: loss tolerance 1e-4 (bf16 epilogue images, see
    test_torch_fused_v2.py), z_star the L-step bound of the loop, 1e-3."""
    jgan, tg = pair
    rng = np.random.RandomState(2)
    x = rng.rand(8, 28, 28, 1).astype(np.float32)
    z0 = rng.randn(8, 2, 32).astype(np.float32)
    ref = jv2i.make_pallas_dense_int8_reconstructor(
        jgan, rec_rr=2, rec_iters=L, rec_lr=LR, momentum=MOM, tile=8,
        interpret=True)(jnp.asarray(x), jax.random.key(0), jnp.asarray(z0))
    got = make_dense_int8_reconstructor(
        tg, (28, 28, 1), rec_rr=2, rec_iters=L, rec_lr=LR,
        momentum=MOM)(torch.from_numpy(x), z0=torch.from_numpy(z0))
    np.testing.assert_allclose(got.all_losses.numpy(),
                               np.asarray(ref.all_losses), atol=1e-4)
    np.testing.assert_array_equal(got.all_losses.numpy().argmin(1),
                                  np.asarray(ref.all_losses).argmin(1))
    np.testing.assert_allclose(got.z_star.numpy(), np.asarray(ref.z_star),
                               atol=1e-3)
