"""PyTorch port vs JAX: gradients through the projection
(reconstruct(back_prop=True), defensegan_torch/defense/project.py and
DefenseGAN.reconstruct) on the CPU.

Tiny wide and deep generators (GEN_DIM 4, LATENT_DIM 32, float32) get the
same weights through ckpt/bridge.py, the same x, z0 and output weights
(numpy, seeded). The scalar differentiated is sum(w_img * x_hat) +
sum(w_loss * loss): both the purified image and the detector statistic,
so the gradient reaches x through every one of the L unrolled steps, the
restart selection's winner and the final loss. It is held against
jax.grad of JAX's reconstruct(back_prop=True) on the generic path and on
`packed` (conv on the wide generator, s2d on the deep one), at L 1, 3 and
8.

Tolerance: atol 1e-4 + rtol 1e-3 of the largest |d/dx| element. The two
packages sum in float32 in different orders (~1e-7 relative) and the
second-order pass through the generator at lr = 10 amplifies that by the
step count; a wrong sign, a dropped term of the Hessian-vector product
or a missing step moves the gradient by tens of percent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.configs import Config as JaxConfig
from defensegan_tpu.defense.project import reconstruct as jax_reconstruct
from defensegan_tpu.gan import DefenseGAN as JaxGAN
from defensegan_torch.ckpt.bridge import load_flax_tree
from defensegan_torch.configs import Config
from defensegan_torch.defense.project import reconstruct
from defensegan_torch.gan import DefenseGAN, resolve_projection_kernel

torch.set_num_threads(2)

LATENT, RR, B = 32, 3, 3


@pytest.fixture(scope="module", params=["wide", "deep"])
def pair(request, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("run"))
    kw = dict(type="mnist", gen_arch=request.param, gen_dim=4, disc_dim=4,
              latent_dim=LATENT, rec_rr=RR, compute_dtype="float32",
              output_dir=out)
    jgan = JaxGAN(JaxConfig(**kw), key=jax.random.key(3))
    rng = np.random.RandomState(5)
    # BatchNorm statistics off the identity, so the fold is exercised
    stats = jax.tree.map(lambda a: np.asarray(a) + 0.3 * rng.rand(
        *a.shape).astype(np.float32), jgan.state.gen_stats)
    jgan.state = jgan.state.replace(gen_stats=stats)
    tgan = DefenseGAN(Config(**kw), device="cpu")
    load_flax_tree(tgan.generator,
                   jax.tree.map(np.asarray, jgan.state.gen_params), stats)
    return jgan, tgan


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, 28, 28, 1).astype(np.float32)
    z0 = rng.randn(B, RR, LATENT).astype(np.float32)
    w_img = rng.randn(B, 28, 28, 1).astype(np.float32)
    w_loss = rng.randn(B).astype(np.float32) * 10.0
    return x, z0, w_img, w_loss


def _objective_jax(res, w_img, w_loss):
    return jnp.sum(res.x_hat.reshape(w_img.shape) * w_img) + \
        jnp.sum(res.loss * w_loss)


def _grad_port(run, x, w_img, w_loss):
    xt = torch.from_numpy(x).requires_grad_(True)
    res = run(xt)
    obj = torch.sum(res.x_hat.reshape(w_img.shape) * torch.from_numpy(
        w_img)) + torch.sum(res.loss * torch.from_numpy(w_loss))
    (g,) = torch.autograd.grad(obj, xt)
    return g.numpy(), res


def _close(got, ref):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 + 1e-3 * scale)


@pytest.mark.parametrize("iters", [1, 3, 8])
def test_generic_path_gradient_matches_jax(pair, iters):
    jgan, tgan = pair
    x, z0, w_img, w_loss = _inputs(iters)

    def f(xx):
        res = jax_reconstruct(jgan.gen_apply_tanh, xx, jnp.asarray(z0),
                              rec_iters=iters, back_prop=True)
        return _objective_jax(res, w_img, w_loss)

    ref = jax.grad(f)(jnp.asarray(x))
    got, res = _grad_port(
        lambda xt: reconstruct(tgan.generator, xt, torch.from_numpy(z0),
                               rec_iters=iters, back_prop=True),
        x, w_img, w_loss)
    assert res.x_hat.shape == (B, 28, 28, 1)
    _close(got, ref)
    # the entry point's `xla` path is the same graph
    got2, _ = _grad_port(
        lambda xt: tgan.reconstruct(xt, kernel="xla", rec_iters=iters,
                                    back_prop=True, z0=torch.from_numpy(z0)),
        x, w_img, w_loss)
    np.testing.assert_allclose(got2, got, rtol=0, atol=1e-6)


@pytest.mark.parametrize("iters", [1, 3, 8])
def test_packed_path_gradient_matches_jax(pair, iters):
    """kernel='auto' on the CPU under back_prop resolves to `packed` on the
    wide generator (as JAX's xla_best) and `xla` on the deep one; an
    explicit `packed` runs the packed variant (conv / s2d) on both."""
    jgan, tgan = pair
    x, z0, w_img, w_loss = _inputs(10 + iters)
    fn, mode = jgan._reconstructor_for("packed", RR, iters,
                                       jgan.cfg.rec_lr, True)
    assert mode == "xz"

    def f(xx):
        return _objective_jax(fn(xx, jnp.asarray(z0)), w_img, w_loss)

    ref = jax.grad(f)(jnp.asarray(x))
    got, _ = _grad_port(
        lambda xt: tgan.reconstruct(xt, kernel="packed", rec_iters=iters,
                                    back_prop=True, z0=torch.from_numpy(z0)),
        x, w_img, w_loss)
    assert tgan.last_kernel == "packed"
    _close(got, ref)


def test_no_gradient_without_back_prop(pair):
    _, tgan = pair
    x, z0, _, _ = _inputs(0)
    xt = torch.from_numpy(x).requires_grad_(True)
    res = tgan.reconstruct(xt, rec_iters=2, z0=torch.from_numpy(z0))
    assert not res.x_hat.requires_grad and not res.loss.requires_grad
    res = tgan.reconstruct(xt, rec_iters=2, z0=torch.from_numpy(z0),
                           back_prop=True)
    assert res.x_hat.requires_grad and res.loss.requires_grad


def test_back_prop_forward_equals_inference_forward(pair):
    """The differentiable loop computes the same values as the inference
    loop: the checkpointed steps take the same float operations."""
    _, tgan = pair
    x, z0, _, _ = _inputs(1)
    a = reconstruct(tgan.generator, torch.from_numpy(x),
                    torch.from_numpy(z0), rec_iters=4)
    b = reconstruct(tgan.generator, torch.from_numpy(x),
                    torch.from_numpy(z0), rec_iters=4, back_prop=True)
    torch.testing.assert_close(b.all_losses.detach(), a.all_losses,
                               rtol=0, atol=0)
    torch.testing.assert_close(b.x_hat.detach(), a.x_hat, rtol=0, atol=0)


def test_gradient_reaches_z0(pair):
    """z0 from an encoder is differentiable in x (attacks/compose.py): the
    loop hands gradients to z0 as well as to x."""
    _, tgan = pair
    x, z0, _, _ = _inputs(2)
    zt = torch.from_numpy(z0).requires_grad_(True)
    res = reconstruct(tgan.generator, torch.from_numpy(x), zt, rec_iters=3,
                      back_prop=True)
    (g,) = torch.autograd.grad(res.x_hat.sum(), zt)
    # only the winning restart of each image reaches G(z*)
    assert torch.isfinite(g).all() and (g.abs().sum(-1) > 0).sum() == B


def test_resolver_under_back_prop(pair):
    """auto gives the plain per-topology path (packed / xla) on CUDA and on
    the CPU; an explicit kernel request under back_prop raises on CUDA
    (the JAX resolver degrades it quietly; the port does not)."""
    jgan, tgan = pair
    best = "packed" if tgan.cfg.gen_arch == "wide" else "xla"
    for on_cuda in (True, False):
        assert resolve_projection_kernel(tgan, requested="auto",
                                         back_prop=True,
                                         on_cuda=on_cuda) == best
    for req in ("packed", "xla"):
        assert resolve_projection_kernel(tgan, requested=req,
                                         back_prop=True,
                                         on_cuda=True) == req
    for req in ("pallas", "pallas_int8", "pallas_v4"):
        with pytest.raises(NotImplementedError, match="no backward pass"):
            resolve_projection_kernel(tgan, requested=req, back_prop=True,
                                      on_cuda=True)
    from defensegan_tpu.gan.defense_gan import \
        resolve_projection_kernel as jax_resolve
    assert jax_resolve(jgan, n=256, back_prop=True, requested="auto",
                       on_tpu=True) == best
