"""PyTorch port vs JAX: the projection core (defensegan_torch/defense/
project.py) and the DefenseGAN entry point on the CPU.

Same weights, x and z0 (numpy, seeded) through both packages in float32
at a small L: the all_losses must agree to rtol 1e-3 and the argmins must
be equal. The tolerance is float32 summation order (~1e-7) amplified by
L momentum-GD steps at lr = 10; 1e-3 leaves room for that and none for a
wrong gradient, loss scale or update rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.defense.project import reconstruct as jax_reconstruct
from defensegan_tpu.models.generator import generator_for as jax_generator
from defensegan_torch.ckpt.bridge import load_flax_tree
from defensegan_torch.configs import Config
from defensegan_torch.defense.fastgen import packed_apply_for
from defensegan_torch.defense.project import (ReconstructionResult,
                                              make_reconstructor,
                                              reconstruct, sample_z0,
                                              select_restarts)
from defensegan_torch.gan import DefenseGAN, resolve_projection_kernel
from defensegan_torch.models.generator import generator_for

torch.set_num_threads(2)

LATENT = 16


def _pair(arch, seed=0):
    jg = jax_generator("mnist", 4, jnp.float32, arch)
    v = jg.init(jax.random.key(seed), jnp.zeros((1, LATENT)))
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    tg = generator_for("mnist", 4, torch.float32, arch, LATENT)
    load_flax_tree(tg, params, stats)

    def jax_apply(z):
        return jg.apply({"params": params, "batch_stats": stats}, z,
                        train=False)
    return jax_apply, params, stats, tg.requires_grad_(False)


def _inputs(b=4, rr=3, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, 28, 28, 1).astype(np.float32)
    z0 = rng.randn(b, rr, LATENT).astype(np.float32)
    return x, z0


def _check(got: ReconstructionResult, ref):
    np.testing.assert_allclose(got.all_losses.numpy(),
                               np.asarray(ref.all_losses), rtol=1e-3)
    np.testing.assert_array_equal(got.all_losses.numpy().argmin(1),
                                  np.asarray(ref.all_losses).argmin(1))
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(ref.loss),
                               rtol=1e-3)
    np.testing.assert_allclose(got.x_hat.numpy().reshape(
        np.asarray(ref.x_hat).shape), np.asarray(ref.x_hat), atol=1e-3)


@pytest.mark.parametrize("arch", ["wide", "deep"])
def test_reconstruct_matches_jax(arch):
    jax_apply, _, _, tg = _pair(arch)
    x, z0 = _inputs()
    ref = jax_reconstruct(jax_apply, jnp.asarray(x), jnp.asarray(z0),
                          rec_iters=6)
    got = reconstruct(tg, torch.from_numpy(x), torch.from_numpy(z0),
                      rec_iters=6)
    assert got.x_hat.shape == (4, 28, 28, 1) and got.z_star.shape == \
        (4, LATENT)
    _check(got, ref)


def test_packed_reconstruct_matches_jax():
    jax_apply, _, _, tg = _pair("wide")
    x, z0 = _inputs(seed=2)
    ref = jax_reconstruct(jax_apply, jnp.asarray(x), jnp.asarray(z0),
                          rec_iters=6)
    got = reconstruct(packed_apply_for(tg, "conv"),
                      torch.from_numpy(x).reshape(4, -1),
                      torch.from_numpy(z0), rec_iters=6)
    _check(got, ref)


def test_defensegan_reconstruct_matches_jax(tmp_path):
    """The entry point (CPU, kernel auto -> packed; xla) with a given z0
    and uint8 input equals JAX's reconstruct on the same weights."""
    cfg = Config(type="mnist", gen_arch="wide", gen_dim=4, latent_dim=LATENT,
                 rec_rr=3, rec_iters=5, compute_dtype="float32",
                 output_dir=str(tmp_path))
    gan = DefenseGAN(cfg, device="cpu")
    jax_apply, params, stats, _ = _pair("wide")
    load_flax_tree(gan.generator, params, stats)
    rng = np.random.RandomState(3)
    x8 = rng.randint(0, 256, (4, 28, 28, 1)).astype(np.uint8)
    z0 = rng.randn(4, 3, LATENT).astype(np.float32)
    ref = jax_reconstruct(jax_apply, jnp.asarray(x8), jnp.asarray(z0),
                          rec_iters=5)
    for kernel, path in (("auto", "packed"), ("xla", "xla"),
                         ("pallas", "packed")):
        got = gan.reconstruct(x8, kernel=kernel, z0=torch.from_numpy(z0))
        assert gan.last_kernel == path
        _check(got, ref)


def test_make_reconstructor_z0_override_and_sampling():
    _, _, _, tg = _pair("wide")
    x, z0 = _inputs(b=2, rr=2, seed=4)
    run = make_reconstructor(tg, rec_rr=2, rec_iters=3, z_dim=LATENT)
    a = run(torch.from_numpy(x), z0=torch.from_numpy(z0))
    b = reconstruct(tg, torch.from_numpy(x), torch.from_numpy(z0),
                    rec_iters=3)
    torch.testing.assert_close(a.all_losses, b.all_losses)
    g = torch.Generator().manual_seed(0)
    c = run(torch.from_numpy(x), g)
    assert not torch.allclose(c.all_losses, a.all_losses)
    z = sample_z0(torch.Generator().manual_seed(0), 2, 2, LATENT)
    assert z.shape == (2, 2, LATENT) and z.dtype == torch.float32


def test_argmin_tie_takes_first_restart():
    losses = torch.tensor([[0.5, 0.2, 0.2], [0.1, 0.1, 0.3]])
    z = torch.arange(6 * 2, dtype=torch.float32).reshape(6, 2)
    res = select_restarts(losses, z, lambda zz: zz)
    np.testing.assert_array_equal(np.asarray(jnp.argmin(
        jnp.asarray(losses.numpy()), axis=1)), [1, 0])
    torch.testing.assert_close(res.z_star, z[[1, 3]])
    torch.testing.assert_close(res.loss, torch.tensor([0.2, 0.1]))


def test_back_prop_raises(tmp_path):
    """back_prop=True runs on the differentiable paths (gradients: see
    tests/test_torch_backprop.py); what raises under it is an explicit
    kernel request on CUDA, which has no backward pass."""
    _, _, _, tg = _pair("wide")
    x, z0 = _inputs(b=1, rr=1)
    xt = torch.from_numpy(x).requires_grad_(True)
    res = reconstruct(tg, xt, torch.from_numpy(z0), rec_iters=2,
                      back_prop=True)
    (g,) = torch.autograd.grad(res.loss.sum(), xt)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    gan = DefenseGAN(Config(type="mnist", gen_arch="wide", gen_dim=4,
                            latent_dim=LATENT, output_dir=str(tmp_path)),
                     device="cpu")
    with pytest.raises(NotImplementedError, match="no backward pass"):
        resolve_projection_kernel(gan, requested="pallas", back_prop=True,
                                  on_cuda=True)


def test_resolve_projection_kernel(tmp_path):
    wide = DefenseGAN(Config(type="mnist", gen_arch="wide", gen_dim=4,
                             latent_dim=LATENT, output_dir=str(tmp_path)),
                      device="cpu")
    deep = DefenseGAN(Config(type="mnist", gen_arch="deep", gen_dim=4,
                             latent_dim=LATENT, output_dir=str(tmp_path)),
                      device="cpu")

    # past the dense-packing bound: 14 * 14 * 128 = 25088 features
    big = DefenseGAN(Config(type="mnist", gen_arch="wide", gen_dim=64,
                            latent_dim=LATENT, output_dir=str(tmp_path)),
                     device="cpu")

    def r(gan, req, back_prop=False, on_cuda=True):
        return resolve_projection_kernel(gan, requested=req,
                                         back_prop=back_prop,
                                         on_cuda=on_cuda)
    assert r(wide, "auto") == "pallas"
    assert r(wide, "pallas") == "pallas"
    assert r(wide, "pallas_int8") == "pallas_int8"
    # only 'auto' and CPU runs degrade quietly; an explicit kernel request
    # on CUDA runs the kernel or raises
    assert r(wide, "auto", back_prop=True) == "packed"
    with pytest.raises(NotImplementedError, match="backward"):
        r(wide, "pallas_int8", back_prop=True)
    assert r(wide, "pallas", on_cuda=False) == "packed"
    assert r(wide, "pallas_int8", back_prop=True, on_cuda=False) == "packed"
    assert r(wide, "xla") == "xla"
    # the deep two-deconv generator runs the bf16 s2d kernel (v3)
    assert r(deep, "auto") == "pallas"
    assert r(deep, "pallas") == "pallas"
    assert r(deep, "pallas", on_cuda=False) == "xla"
    assert r(big, "auto") == "packed"
    with pytest.raises(NotImplementedError, match="no ported kernel"):
        r(big, "pallas")
    # pallas_v4 serves multi-deconv generators, the deep one as its edge
    # case; a single-deconv generator has the dense kernels
    with pytest.raises(NotImplementedError, match="pallas_v4"):
        r(wide, "pallas_v4")
    assert r(deep, "pallas_v4") == "pallas_v4"
    assert r(deep, "pallas_v4", on_cuda=False) == "xla"
    with pytest.raises(NotImplementedError, match="backward"):
        r(deep, "pallas_v4", back_prop=True)
    with pytest.raises(ValueError):
        r(wide, "nope")
    # the CPU model resolves from its own device
    assert resolve_projection_kernel(wide) == "packed"
