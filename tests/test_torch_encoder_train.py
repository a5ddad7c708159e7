"""PyTorch port vs JAX: the amortized-inversion encoder's training
(defensegan_torch/defense/encoder_init.py, DefenseGAN.train_encoder) on
the CPU.

One Adam step of the encoder (MNIST family, DISC_DIM 4, LATENT_DIM 16,
float32, B 8) against a frozen deep generator (GEN_DIM 4, inference
mode), both packages from the same flax weights, the port handed JAX's
draws (the key split into k_idx, k_z, k_n: the minibatch, the latents and,
with noise_aug > 0, the U[-a, a] image noise). Tolerances (float32,
summation order): img_mse, z_cycle and the loss rtol 1e-5; Adam's first
and second moments within 1e-4 / 1e-3 of each leaf's largest element; the
parameters within 0.02 lr where sqrt(nu_hat) >= 1e-6 (elsewhere within
2 lr: Adam's first step is lr g / (|g| + eps), whose sign rounding noise
decides). Then DefenseGAN.train_encoder writes the encoder into the run's
weight export and DefenseGAN.load reads it back.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.defense.encoder_init import \
    make_encoder_train_step as jax_encoder_step
from defensegan_tpu.models import encoder_for as jax_encoder_for
from defensegan_tpu.models import generator_for as jax_generator_for
from defensegan_torch.ckpt.bridge import flax_tree, load_flax_tree
from defensegan_torch.configs import Config
from defensegan_torch.defense.encoder_init import (EncoderDraws,
                                                   make_encoder_train_step)
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.models import encoder_for, generator_for

torch.set_num_threads(2)

K, B, N, LR = 16, 8, 32, 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tree_of(module, tensors):
    shadow = copy.deepcopy(module)
    with torch.no_grad():
        for p, t in zip(shadow.parameters(), tensors):
            p.copy_(t)
    return flax_tree(shadow)[0]


def _close_rel(got, ref, rel):
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= rel * scale


@pytest.mark.parametrize("noise_aug", [0.0, 0.1])
def test_encoder_step_matches_jax(noise_aug):
    jg = jax_generator_for("mnist", 4, arch="deep")
    gvars = jax.tree.map(np.asarray, jax.jit(
        lambda k: jg.init(k, jnp.zeros((1, K)), train=True))(
        jax.random.key(0)))
    je = jax_encoder_for("mnist", 4, z_dim=K)
    eparams = _np(jax.jit(je.init)(jax.random.key(1),
                                   jnp.zeros((1, 28, 28, 1)))["params"])
    data = np.random.RandomState(2).rand(N, 28, 28, 1).astype(np.float32)
    step, tx = jax_encoder_step(
        je, lambda z: jg.apply(gvars, z, train=False), batch_size=B, lr=LR,
        beta_z=0.5, noise_aug=noise_aug)
    key = jax.random.key(3)
    new_params, opt, jm = jax.jit(step)(eparams, tx.init(eparams),
                                        jnp.asarray(data), key)
    k_idx, k_z, k_n = jax.random.split(key, 3)
    draws = EncoderDraws(
        torch.from_numpy(np.array(jax.random.randint(k_idx, (B,), 0, N))),
        torch.from_numpy(np.array(jax.random.normal(k_z, (B, K)))),
        torch.from_numpy(np.array(jax.random.uniform(
            k_n, (B, 28, 28, 1), jnp.float32, -noise_aug, noise_aug))))

    tg = load_flax_tree(generator_for("mnist", 4, arch="deep", latent_dim=K),
                        gvars["params"], gvars["batch_stats"]) \
        .requires_grad_(False)
    te = load_flax_tree(encoder_for("mnist", 4, z_dim=K), eparams)
    opt_t = torch.optim.Adam(te.parameters(), lr=LR, betas=(0.9, 0.999),
                             eps=1e-8)
    tm = make_encoder_train_step(te, tg, opt_t, batch_size=B, beta_z=0.5,
                                 noise_aug=noise_aug)(
        torch.from_numpy(data), None, draws)
    for k in ("img_mse", "z_cycle", "loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    adam = opt[0]
    for key_t, ref, rel in (("exp_avg", adam.mu, 1e-4),
                            ("exp_avg_sq", adam.nu, 1e-3)):
        got = _tree_of(te, [opt_t.state[p][key_t] for p in te.parameters()])
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(_np(ref))):
            _close_rel(a, b, rel)
    got = flax_tree(te)[0]
    for a, b, v in zip(jax.tree.leaves(got), jax.tree.leaves(_np(new_params)),
                       jax.tree.leaves(_np(adam.nu))):
        diff = np.abs(a - b) / LR
        sure = np.sqrt(v / (1.0 - 0.999)) >= 1e-6
        assert float(diff[sure].max(initial=0.0)) <= 0.02
        assert float(diff.max()) <= 2.0001
    assert not any(p.grad is not None for p in tg.parameters())


def test_train_encoder_writes_the_export_that_load_reads(tmp_path):
    cfg = Config(type="mnist", gen_arch="wide", gen_dim=4, disc_dim=4,
                 latent_dim=K, batch_size=B, disc_iters=1,
                 compute_dtype="float32", output_dir=str(tmp_path),
                 save_every=1, sample_every=0, encoder_batch=B)
    data = np.random.RandomState(4).rand(N, 28, 28, 1).astype(np.float32)
    gan = DefenseGAN(cfg, device="cpu")
    gan.train(data, train_iters=1, quiet=True)
    z = torch.randn(4, K, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        before = gan.generator(z)
    m = gan.train_encoder(data, iters=6, chunk=3, quiet=True)
    assert [h["step"] for h in m["history"]] == [3, 6]
    assert np.isfinite(m["img_mse"]) and m["wall_s"] > 0
    back = DefenseGAN(cfg, device="cpu").load()
    assert back.has_encoder() and back.step == 1
    x = torch.rand(4, 28, 28, 1, generator=torch.Generator().manual_seed(1))
    assert torch.equal(back.encode(x), gan.encode(x))
    with torch.no_grad():
        # the generator stayed frozen, and the export kept it and the critic
        assert torch.equal(gan.generator(z), before)
        assert torch.equal(back.generator(z), before)
    assert back.critic is not None
    res = back.reconstruct(x, rec_rr=2, rec_iters=2, init="encoder")
    assert torch.isfinite(res.loss).all()
