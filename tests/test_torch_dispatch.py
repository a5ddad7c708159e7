"""PyTorch port: which projection path runs on the deep two-deconv
generator and on the 64x64 stacks (defensegan_torch/gan/defense_gan.py),
and the `packed` route's parity with the JAX package.

`resolve_projection_kernel` is held against the JAX package's resolver on
the same requests (JAX's on_tpu plays the port's on_cuda; JAX degrades a
kernel request under back_prop to the plain path where the port raises;
on a 64x64 stack the port's `auto` runs v4 where JAX's runs `xla`).
`packed` with PACKED_VARIANT auto packs s2d on a deep generator in both
packages, runs the loop in s2d pixel order and returns x_hat in image
order: float32, same weights, x and z0, tolerance 1e-3 relative on the
losses (float32 summation order carried through the lr = 10 momentum
steps), equal argmins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.configs import Config as JaxConfig
from defensegan_tpu.gan import DefenseGAN as JaxGAN
from defensegan_tpu.gan.defense_gan import \
    resolve_projection_kernel as jax_resolve
from defensegan_torch.ckpt.bridge import load_flax_tree
from defensegan_torch.configs import Config
from defensegan_torch.defense import fastgen
from defensegan_torch.gan import DefenseGAN, resolve_projection_kernel
from defensegan_torch.gan.defense_gan import _resolve

torch.set_num_threads(2)

LATENT, RR, ITERS = 16, 3, 5


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("run"))
    kw = dict(type="mnist", gen_arch="deep", gen_dim=4, disc_dim=4,
              latent_dim=LATENT, rec_rr=RR, rec_iters=ITERS,
              compute_dtype="float32", output_dir=out)
    jgan = JaxGAN(JaxConfig(**kw))
    tgan = DefenseGAN(Config(**kw), device="cpu")
    load_flax_tree(tgan.generator,
                   jax.tree.map(np.asarray, jgan.state.gen_params),
                   jax.tree.map(np.asarray, jgan.state.gen_stats))
    return jgan, tgan


@pytest.mark.parametrize("requested,on_cuda,back_prop,path", [
    ("auto", True, False, "pallas"),
    ("pallas", True, False, "pallas"),
    ("pallas_int8", True, False, "pallas"),      # bf16 v3: no int8 deep loop
    ("packed", True, False, "packed"),
    ("xla", True, False, "xla"),
    ("auto", True, True, "xla"),
    ("packed", True, True, "packed"),
    ("xla", True, True, "xla"),
    ("auto", False, False, "xla"),
    ("pallas", False, False, "xla"),
    ("pallas_int8", False, False, "xla"),
    ("packed", False, False, "packed"),
    ("xla", False, False, "xla"),
    ("pallas", False, True, "xla"),
])
def test_deep_dispatch_matches_jax(pair, requested, on_cuda, back_prop, path):
    jgan, tgan = pair
    got = resolve_projection_kernel(tgan, requested=requested,
                                    back_prop=back_prop, on_cuda=on_cuda)
    assert got == path
    # n = 64 rows: a batch JAX's tile-64 guard lets through (the port pads)
    assert jax_resolve(jgan, n=64, back_prop=back_prop, requested=requested,
                       on_tpu=on_cuda) == path


@pytest.mark.parametrize("requested", ["pallas", "pallas_int8"])
def test_deep_kernel_request_under_back_prop_raises_on_cuda(pair, requested):
    """An explicit kernel request that cannot run raises on CUDA instead
    of changing path quietly (JAX degrades it to the plain path)."""
    _, tgan = pair
    with pytest.raises(NotImplementedError, match="backward"):
        resolve_projection_kernel(tgan, requested=requested, back_prop=True,
                                  on_cuda=True)


def test_uncovered_generator_still_raises_and_names_the_roadmap(tmp_path):
    """'pallas' / 'pallas_int8' name the dense and s2d kernels, which do not
    cover a 64x64 stack: they still raise there, and the message names the
    request that does serve it. ROADMAP.md has no kernel left to name."""
    celeba = DefenseGAN(Config(type="celeba", gen_arch="deep", gen_dim=2,
                               latent_dim=8, image_size=64, channels=3,
                               output_dir=str(tmp_path)), device="cpu")
    assert resolve_projection_kernel(celeba, requested="auto",
                                     on_cuda=True) == "pallas_v4"
    for requested in ("pallas", "pallas_int8"):
        with pytest.raises(NotImplementedError, match="'pallas_v4' serves"):
            resolve_projection_kernel(celeba, requested=requested,
                                      on_cuda=True)
    assert resolve_projection_kernel(celeba, requested="pallas_v4",
                                     on_cuda=True) == "pallas_v4"


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    """JAX and port models of every topology `pallas_v4` is asked for:
    the 64x64 stacks, the two-deconv MNIST deep generator (v4's edge
    case) and the single-deconv wide one (not covered)."""
    out = str(tmp_path_factory.mktemp("stacks"))
    made = {}
    for name, kw in (
            ("celeba_deep", dict(type="celeba", gen_arch="deep",
                                 image_size=64, channels=3)),
            ("celeba_wide", dict(type="celeba", gen_arch="wide",
                                 image_size=64, channels=3)),
            ("imagenet64", dict(type="imagenet64", gen_arch="deep",
                                image_size=64, channels=3)),
            ("mnist_deep", dict(type="mnist", gen_arch="deep")),
            ("mnist_wide", dict(type="mnist", gen_arch="wide"))):
        kw = dict(kw, gen_dim=4, disc_dim=4, latent_dim=LATENT,
                  output_dir=out)
        made[name] = (JaxGAN(JaxConfig(**kw)),
                      DefenseGAN(Config(**kw), device="cpu"))
    return made


@pytest.mark.parametrize("name,requested,on_cuda,back_prop,path", [
    ("celeba_deep", "pallas_v4", True, False, "pallas_v4"),
    ("celeba_wide", "pallas_v4", True, False, "pallas_v4"),
    ("mnist_deep", "pallas_v4", True, False, "pallas_v4"),
    ("celeba_deep", "auto", True, True, "xla"),
    ("celeba_deep", "xla", True, False, "xla"),
    ("celeba_deep", "packed", True, False, "packed"),
    ("celeba_deep", "pallas_v4", False, False, "xla"),
    ("celeba_wide", "pallas_v4", False, True, "xla"),
    ("mnist_deep", "pallas_v4", False, False, "xla"),
    ("mnist_wide", "pallas_v4", False, False, "packed"),
    ("celeba_deep", "auto", False, False, "xla"),
])
def test_v4_dispatch_matches_jax(stacks, name, requested, on_cuda, back_prop,
                                 path):
    jgan, tgan = stacks[name]
    assert resolve_projection_kernel(tgan, requested=requested,
                                     back_prop=back_prop,
                                     on_cuda=on_cuda) == path
    # n = 64 rows: a multiple of the JAX kernel's tile of 32 (the port pads
    # the rows itself and so has no such guard)
    assert jax_resolve(jgan, n=64, back_prop=back_prop, requested=requested,
                       on_tpu=on_cuda) == path


@pytest.mark.parametrize("name", ["celeba_deep", "celeba_wide",
                                  "imagenet64"])
def test_v4_auto_on_card_diverges_from_jax(stacks, name):
    """A stated divergence: on CUDA without back_prop the port's `auto`
    runs v4 on a 64x64 stack, which neither v2 nor v3 covers, where the
    JAX resolver keeps v4 opt-in and runs `xla`."""
    jgan, tgan = stacks[name]
    assert resolve_projection_kernel(tgan, requested="auto",
                                     back_prop=False,
                                     on_cuda=True) == "pallas_v4"
    assert jax_resolve(jgan, n=64, back_prop=False, requested="auto",
                       on_tpu=True) == "xla"


@pytest.mark.parametrize("name,requested,path,loop", [
    ("mnist_wide", "auto", "pallas", "v2"),
    ("mnist_wide", "pallas", "pallas", "v2"),
    ("mnist_wide", "pallas_int8", "pallas_int8", "v2i"),
    ("mnist_deep", "auto", "pallas", "v3"),
    ("mnist_deep", "pallas", "pallas", "v3"),
    ("mnist_deep", "pallas_int8", "pallas", "v3"),
    ("mnist_deep", "pallas_v4", "pallas_v4", "v4"),
    ("celeba_deep", "auto", "pallas_v4", "v4"),
    ("celeba_wide", "auto", "pallas_v4", "v4"),
    ("imagenet64", "pallas_v4", "pallas_v4", "v4"),
    ("mnist_wide", "packed", "packed", "packed"),
    ("celeba_deep", "xla", "xla", "xla"),
])
def test_each_topology_resolves_to_its_loop(stacks, name, requested, path,
                                            loop):
    """The resolver names the path and, once, the loop that serves it (on
    CUDA): the wide generator v2, or v2i under pallas_int8; the deep one v3
    under both bf16 and int8 requests; a 64x64 stack v4."""
    _, tgan = stacks[name]
    assert _resolve(tgan, requested=requested, on_cuda=True) == (path, loop)
    assert resolve_projection_kernel(tgan, requested=requested,
                                     on_cuda=True) == path


@pytest.mark.parametrize("name,back_prop,match", [
    ("mnist_wide", False, "single-deconv"),
    ("celeba_deep", True, "backward"),
    ("mnist_deep", True, "backward"),
])
def test_v4_request_that_cannot_run_raises_on_cuda(stacks, name, back_prop,
                                                   match):
    """Where the JAX package degrades an explicit `pallas_v4` to the plain
    path (a generator v4 does not cover; back_prop), the port raises on
    CUDA, as it does for the other kernels."""
    jgan, tgan = stacks[name]
    with pytest.raises(NotImplementedError, match=match):
        resolve_projection_kernel(tgan, requested="pallas_v4",
                                  back_prop=back_prop, on_cuda=True)
    assert jax_resolve(jgan, n=64, back_prop=back_prop,
                       requested="pallas_v4", on_tpu=True) in ("xla", "packed")


def test_cpu_pallas_v4_on_a_64x64_stack_runs_the_plain_path(stacks):
    _, tgan = stacks["celeba_wide"]
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.rand(2, 64, 64, 3).astype(np.float32))
    z0 = torch.from_numpy(rng.randn(2, 2, LATENT).astype(np.float32))
    res = tgan.reconstruct(x, kernel="pallas_v4", z0=z0, rec_iters=2)
    assert tgan.last_kernel == "xla"
    assert res.x_hat.shape == (2, 64, 64, 3)
    assert res.all_losses.shape == (2, 2)


def _inputs(seed=0, b=4):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, 28, 28, 1).astype(np.float32),
            rng.randn(b, RR, LATENT).astype(np.float32))


def _jax_packed(jgan, x, z0):
    fn, mode = jgan._reconstructor_for("packed", RR, ITERS, jgan.cfg.rec_lr,
                                       False)
    assert mode == "xz"
    return fn(jnp.asarray(x), jnp.asarray(z0))


def test_packed_auto_on_deep_takes_the_s2d_route(pair, monkeypatch):
    jgan, tgan = pair
    x, z0 = _inputs()
    ref = _jax_packed(jgan, x, z0)
    seen = []
    real = fastgen.pack_generator
    monkeypatch.setattr(
        fastgen, "pack_generator",
        lambda g, variant="conv", dtype=None: (
            seen.append(variant), real(g, variant, dtype))[1])
    tgan._reconstructors.clear()
    got = tgan.reconstruct(torch.from_numpy(x), kernel="packed",
                           z0=torch.from_numpy(z0))
    assert seen == ["s2d"] and tgan.last_kernel == "packed"
    assert got.x_hat.shape == (4, 28, 28, 1)
    np.testing.assert_allclose(got.all_losses.numpy(),
                               np.asarray(ref.all_losses), rtol=1e-3)
    np.testing.assert_array_equal(got.all_losses.numpy().argmin(1),
                                  np.asarray(ref.all_losses).argmin(1))
    # x_hat is back in image order: equal to JAX's and to the plain path's
    np.testing.assert_allclose(got.x_hat.numpy(), np.asarray(ref.x_hat),
                               atol=1e-3)
    xla = tgan.reconstruct(torch.from_numpy(x), kernel="xla",
                           z0=torch.from_numpy(z0))
    np.testing.assert_allclose(got.x_hat.numpy(), xla.x_hat.numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(got.all_losses.numpy(),
                               xla.all_losses.numpy(), rtol=1e-3)


@pytest.mark.parametrize("variant", ["conv", "phase", "hybrid", "s2d"])
def test_packed_variants_agree_on_deep(pair, variant):
    """Every PACKED_VARIANT the JAX package accepts runs in the port and
    projects to the same result as the plain path."""
    _, tgan = pair
    x, z0 = _inputs(seed=1)
    xla = tgan.reconstruct(torch.from_numpy(x), kernel="xla",
                           z0=torch.from_numpy(z0))
    gan = DefenseGAN(tgan.cfg.replace(packed_variant=variant), device="cpu")
    gan.generator.load_state_dict(tgan.generator.state_dict())
    got = gan.reconstruct(torch.from_numpy(x), kernel="packed",
                          z0=torch.from_numpy(z0))
    np.testing.assert_allclose(got.all_losses.numpy(),
                               xla.all_losses.numpy(), rtol=1e-3)
    np.testing.assert_allclose(got.x_hat.numpy(), xla.x_hat.numpy(),
                               atol=1e-3)


def test_cpu_auto_on_deep_runs_the_plain_path(pair):
    _, tgan = pair
    x, z0 = _inputs(seed=2, b=2)
    tgan.reconstruct(torch.from_numpy(x), z0=torch.from_numpy(z0))
    assert tgan.last_kernel == "xla"
