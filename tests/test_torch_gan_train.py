"""PyTorch port vs JAX: WGAN-GP training (defensegan_torch/gan/losses.py,
gan/train.py) and the trainer of gan/defense_gan.py, on the CPU.

Both packages start from the same flax-initialized weights (deep MNIST
generator and critic at GEN_DIM / DISC_DIM 4, LATENT_DIM 16, float32),
B 8, disc_iters 2, and the port is handed JAX's own draws: the minibatch
indices, every critic iteration's z and eps and the generator's z,
rebuilt from JAX's key splits (gan/train.py: idx from k_idx, then k_disc
split per critic iteration into kz / ke, and k_gen).

Tolerances (float32, summation order only):
  - the gradient penalty and the losses: rtol 1e-5; their gradients with
    respect to the critic's and the generator's parameters: max |diff|
    within 1e-5 of the largest element (the penalty's second-order pass
    sums in another order);
  - after 1 and 3 train steps: the metrics rtol 1e-5 / atol 1e-6; Adam's
    first moments within 1e-4 and second moments within 1e-3 of each
    leaf's largest element; the BatchNorm running statistics within
    1e-6, a running mean also within the drift of the noise-driven bias
    before it (below: 0.01 x 2 lr a step, summed); the parameters within 0.02 lr where JAX's bias-corrected second
    moment sqrt(nu_hat) is at least 1e-6. Adam's first step moves a
    weight by lr g / (|g| + eps): where the gradient is rounding noise
    (the bias of a deconv before a BatchNorm has an exact gradient of 0)
    the sign of the step is the noise's, so there the parameters agree
    only within the most the steps can move two copies apart, 2 steps lr.
The uint8 data step, the critic updates' hands-off on the running
statistics, divergence handling, save -> export -> load and resume are
held on the port alone.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.gan.losses import critic_loss_fn as jax_critic_loss
from defensegan_tpu.gan.losses import generator_loss_fn as jax_gen_loss
from defensegan_tpu.gan.losses import gradient_penalty as jax_gp
from defensegan_tpu.gan.train import build_optimizers as jax_optimizers
from defensegan_tpu.gan.train import init_gan_state as jax_init_state
from defensegan_tpu.gan.train import make_data_train_step as jax_data_step
from defensegan_tpu.models import critic_for as jax_critic_for
from defensegan_tpu.models import generator_for as jax_generator_for
from defensegan_torch.ckpt import latest_step
from defensegan_torch.ckpt.bridge import flax_tree, load_flax_tree
from defensegan_torch.configs import Config
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.gan.losses import (critic_loss_fn, generator_loss_fn,
                                         gradient_penalty)
from defensegan_torch.gan.train import (Draws, init_gan_state,
                                        make_data_train_step)
from defensegan_torch.models import critic_for, generator_for
from defensegan_torch.utils.misc import fold_seed

torch.set_num_threads(2)

K, B, DI, N, LR = 16, 8, 2, 32, 1e-4
SHAPE = (28, 28, 1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_state():
    jg = jax_generator_for("mnist", 4, arch="deep")
    jc = jax_critic_for("mnist", 4)
    gtx, dtx = jax_optimizers()
    state = jax.jit(lambda k: jax_init_state(jg, jc, k, SHAPE, K, gtx, dtx)
                    )(jax.random.key(0))
    return jg, jc, gtx, dtx, state


def _port_modules(state):
    tg = load_flax_tree(generator_for("mnist", 4, arch="deep", latent_dim=K),
                        _np(state.gen_params), _np(state.gen_stats))
    tc = load_flax_tree(critic_for("mnist", 4), _np(state.disc_params))
    return tg, tc


def jax_draws(key, n_data=N, batch=B, disc_iters=DI) -> Draws:
    """The draws JAX's data step makes from `key`, for the port."""
    k_idx, k_step = jax.random.split(key)
    idx = jax.random.randint(k_idx, (disc_iters, batch), 0, n_data)
    k_disc, k_gen = jax.random.split(k_step)
    zs, es = [], []
    for k in jax.random.split(k_disc, disc_iters):
        kz, ke = jax.random.split(k)
        zs.append(jax.random.normal(kz, (batch, K), jnp.float32))
        es.append(jax.random.uniform(ke, (batch,), jnp.float32))
    zg = jax.random.normal(k_gen, (batch, K), jnp.float32)

    def t(a):
        return torch.from_numpy(np.array(a))
    return Draws(t(jnp.stack(zs)), t(jnp.stack(es)), t(zg), t(idx).long())


def _data(u8=False):
    rng = np.random.RandomState(5)
    if u8:
        return rng.randint(0, 256, (N,) + SHAPE).astype(np.uint8)
    return rng.rand(N, *SHAPE).astype(np.float32)


def _close_rel(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= rel * scale, \
        (float(np.abs(got - ref).max()), scale)


def _tree_of(module, tensors):
    """Per-parameter tensors of the port (gradients, Adam moments; in
    parameter order) as a flax tree in flax's layouts."""
    shadow = copy.deepcopy(module)
    with torch.no_grad():
        for p, t in zip(shadow.parameters(), tensors):
            p.copy_(t)
    return flax_tree(shadow)[0]


def _exact_zero(name, leaf):
    """The bias of a deconv that feeds a BatchNorm: the batch mean removes
    it, so its exact gradient is 0 and both packages hold rounding noise
    there."""
    return name.startswith("deconv_") and name != "deconv_out" \
        and leaf == "bias"


def _assert_trees(got, ref, rel, noise=1e-6):
    """Leaf by leaf within rel of the leaf's largest element; a leaf whose
    exact value is 0 within `noise` on both sides."""
    ref = _np(ref)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for name in got:
        for leaf in got[name]:
            if _exact_zero(name, leaf):
                assert np.abs(got[name][leaf]).max() < noise
                assert np.abs(ref[name][leaf]).max() < noise
                continue
            _close_rel(got[name][leaf], ref[name][leaf], rel)


# ---------------------------------------------------------------- losses
def test_gradient_penalty_linear_critic_closed_form():
    """D(x) = sum(x): the gradient is all ones, the norm sqrt(P), the
    penalty (sqrt(P) - 1)^2."""
    real = torch.zeros((4,) + SHAPE)
    fake = torch.ones((4,) + SHAPE)
    eps = torch.linspace(0.1, 0.9, 4)
    gp = gradient_penalty(lambda x: x.sum((1, 2, 3)), real, fake, eps)
    np.testing.assert_allclose(float(gp), (np.sqrt(784) - 1.0) ** 2,
                               rtol=1e-5)


def test_losses_and_gradients_match_jax():
    jg, jc, _, _, st = _jax_state()
    tg, tc = _port_modules(st)
    d = jax_draws(jax.random.key(9))
    real = _data()[:B] * 2.0 - 1.0
    gvars = {"params": st.gen_params, "batch_stats": st.gen_stats}
    fake = np.asarray(jg.apply(gvars, jnp.asarray(d.z_critic[0].numpy()),
                               train=True, mutable=["batch_stats"])[0])
    eps = d.eps[0].numpy()

    def jcrit(p):
        return lambda x: jc.apply({"params": p}, x)
    jgp, jgp_grad = jax.jit(jax.value_and_grad(
        lambda p: jax_gp(jcrit(p), real, fake, eps)))(st.disc_params)
    (jloss, jaux), jgrad = jax.jit(jax.value_and_grad(
        lambda p: jax_critic_loss(jcrit(p), real, fake, eps),
        has_aux=True))(st.disc_params)
    with torch.no_grad():
        tfake = tg(d.z_critic[0], train=True)
    np.testing.assert_allclose(tfake.numpy(), fake, atol=2e-6)
    treal = torch.from_numpy(real)
    gp = gradient_penalty(tc, treal, tfake, d.eps[0])
    np.testing.assert_allclose(float(gp.detach()), float(jgp), rtol=1e-5)
    _assert_trees(_tree_of(tc, torch.autograd.grad(gp, list(
        tc.parameters()), allow_unused=True, materialize_grads=True)),
        jgp_grad, 1e-5)
    loss, aux = critic_loss_fn(tc, treal, tfake, d.eps[0])
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k].detach()), float(v),
                                   rtol=1e-5,
                                   atol=1e-7)
    _assert_trees(_tree_of(tc, torch.autograd.grad(
        loss, list(tc.parameters()))), jgrad, 1e-5)

    # the generator loss through the training-mode generator and critic
    def jg_loss(gp_):
        f = jg.apply({"params": gp_, "batch_stats": st.gen_stats},
                     jnp.asarray(d.z_gen.numpy()), train=True,
                     mutable=["batch_stats"])[0]
        return jax_gen_loss(jcrit(st.disc_params), f)
    jgl, jggrad = jax.jit(jax.value_and_grad(jg_loss))(st.gen_params)
    gl = generator_loss_fn(tc, tg(d.z_gen, train=True))
    np.testing.assert_allclose(float(gl.detach()), float(jgl), rtol=1e-5)
    _assert_trees(_tree_of(tg, torch.autograd.grad(
        gl, list(tg.parameters()))), jggrad, 1e-5)


# ------------------------------------------------------------ train steps
def _moments(module, opt, key):
    return _tree_of(module, [opt.state[p][key] for p in module.parameters()])


@pytest.fixture(scope="module")
def trajectories():
    """JAX and the port, 3 data steps from the same weights and draws;
    each side's state after step 1 and after step 3."""
    jg, jc, gtx, dtx, st = _jax_state()
    tg, tc = _port_modules(st)
    state = init_gan_state(tg, tc)
    jstep = jax.jit(jax_data_step(jg, jc, gtx, dtx, latent_dim=K,
                                  batch_size=B, disc_iters=DI))
    tstep = make_data_train_step(state, latent_dim=K, batch_size=B,
                                 disc_iters=DI)
    data = _data()
    jax_out, port_out = {}, {}
    for s in range(1, 4):
        key = jax.random.key(100 + s)
        st, jm = jstep(st, jnp.asarray(data), key)
        tm = tstep(torch.from_numpy(data), None, jax_draws(key))
        if s in (1, 3):
            jax_out[s] = (st, _np(jm))
            gp, gs = flax_tree(tg)
            port_out[s] = dict(
                metrics={k: float(v) for k, v in tm.items()},
                gen=gp, stats=gs, disc=flax_tree(tc)[0],
                gen_mu=_moments(tg, state.gen_opt, "exp_avg"),
                gen_nu=_moments(tg, state.gen_opt, "exp_avg_sq"),
                disc_mu=_moments(tc, state.disc_opt, "exp_avg"),
                disc_nu=_moments(tc, state.disc_opt, "exp_avg_sq"),
                step=state.step)
    return jax_out, port_out


def _assert_params_in_lr_units(got, ref, nu, steps):
    b2 = 0.9
    for a, b, v in zip(jax.tree.leaves(got), jax.tree.leaves(_np(ref)),
                       jax.tree.leaves(_np(nu))):
        diff = np.abs(a - b) / LR
        sure = np.sqrt(v / (1.0 - b2 ** steps)) >= 1e-6
        assert float(diff[sure].max(initial=0.0)) <= 0.02
        # elsewhere: each side's Adam step is at most lr, in either sign
        assert float(diff.max()) <= 2.0 * steps * 1.0001


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(trajectories, steps):
    (st, jm), port = trajectories[0][steps], trajectories[1][steps]
    assert port["step"] == steps == int(st.step)
    for k, v in jm.items():
        np.testing.assert_allclose(port["metrics"][k], float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    gen_adam, disc_adam = st.gen_opt_state[0], st.disc_opt_state[0]
    _assert_trees(port["gen_mu"], gen_adam.mu, 1e-4)
    _assert_trees(port["gen_nu"], gen_adam.nu, 1e-3)
    _assert_trees(port["disc_mu"], disc_adam.mu, 1e-4)
    _assert_trees(port["disc_nu"], disc_adam.nu, 1e-3)
    # a running mean also holds 0.01 x the bias of the deconv before it,
    # whose rounding-noise steps (above) can part by 2 lr a step
    drift = 0.01 * LR * steps * (steps - 1)
    for name, s in _np(st.gen_stats).items():
        np.testing.assert_allclose(port["stats"][name]["var"], s["var"],
                                   atol=1e-6)
        np.testing.assert_allclose(port["stats"][name]["mean"], s["mean"],
                                   atol=1e-6 + drift)
    _assert_params_in_lr_units(port["gen"], st.gen_params, gen_adam.nu,
                               steps)
    _assert_params_in_lr_units(port["disc"], st.disc_params, disc_adam.nu,
                               steps)


def test_critic_updates_leave_running_stats_alone():
    """After a step, the running statistics are one update of the
    pre-step ones by the generator step's batch alone: the disc_iters
    critic forwards in training mode added nothing."""
    _, _, _, _, st = _jax_state()
    tg, tc = _port_modules(st)
    before = copy.deepcopy(tg)
    state = init_gan_state(tg, tc)
    d = jax_draws(jax.random.key(3))
    make_data_train_step(state, latent_dim=K, batch_size=B, disc_iters=DI)(
        torch.from_numpy(_data()), None, d)
    with torch.no_grad():
        before(d.z_gen, train=True, update_stats=True)
    for (k, a), (_, b) in zip(before.named_buffers(), tg.named_buffers()):
        assert torch.equal(a, b), k
    assert not torch.equal(before.bn_in.scale, tg.bn_in.scale)


def test_uint8_data_step_matches_jax():
    jg, jc, gtx, dtx, st = _jax_state()
    tg, tc = _port_modules(st)
    state = init_gan_state(tg, tc)
    data = _data(u8=True)
    key = jax.random.key(11)
    _, jm = jax.jit(jax_data_step(jg, jc, gtx, dtx, latent_dim=K,
                                  batch_size=B, disc_iters=DI))(
        st, jnp.asarray(data), key)
    tm = make_data_train_step(state, latent_dim=K, batch_size=B,
                              disc_iters=DI)(torch.from_numpy(data), None,
                                             jax_draws(key))
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ------------------------------------------------------------- the trainer
def _cfg(out, **kw):
    base = dict(type="mnist", gen_arch="wide", gen_dim=4, disc_dim=4,
                latent_dim=K, batch_size=B, disc_iters=DI,
                compute_dtype="float32", output_dir=str(out), save_every=2,
                sample_every=2, seed=3)
    base.update(kw)
    return Config(**base)


def test_save_export_load_gives_the_same_model(tmp_path):
    gan = DefenseGAN(_cfg(tmp_path), device="cpu")
    out = gan.train(_data(), train_iters=2, log_every=1, quiet=True)
    assert gan.step == 2 and np.isfinite(out["train_steps_per_s"])
    assert not any(p.requires_grad for p in gan.generator.parameters())
    back = DefenseGAN(_cfg(tmp_path), device="cpu").load()
    assert back.step == 2
    z = torch.randn(5, K, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(back.generator(z), gan.generator(z))
        x = torch.rand((5,) + SHAPE)
        assert torch.equal(back.critic(x), gan.critic(x))
    rows = [json.loads(line) for line in
            open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    assert {"d_real", "d_fake", "gp", "wasserstein", "d_loss",
            "g_loss"} <= set(rows[0])
    assert (tmp_path / "samples" / "sample_0000002.png").exists()
    assert latest_step(str(tmp_path)) == 2


def test_resume_continues_as_an_unbroken_run(tmp_path):
    whole = DefenseGAN(_cfg(tmp_path / "a"), device="cpu")
    whole.train(_data(), train_iters=4, quiet=True, log_every=1)
    first = DefenseGAN(_cfg(tmp_path / "b"), device="cpu")
    first.train(_data(), train_iters=2, quiet=True, log_every=1)
    resumed = DefenseGAN(_cfg(tmp_path / "b"), device="cpu")
    assert resumed.can_restore()
    resumed.restore()
    assert resumed.step == 2
    resumed.train(_data(), train_iters=4, quiet=True, log_every=1)
    for part in ("generator", "critic", "gen_opt", "disc_opt"):
        a = getattr(whole.state, part).state_dict()
        b = getattr(resumed.state, part).state_dict()
        if part.endswith("opt"):
            a, b = a["state"], b["state"]
            a = {k: v for i in a for k, v in
                 (((f"{i}/{n}", t) for n, t in a[i].items()))}
            b = {k: v for i in b for k, v in
                 (((f"{i}/{n}", t) for n, t in b[i].items()))}
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (part, k)

    def rows(d):
        return [{k: v for k, v in json.loads(line).items()
                 if k != "wall_s"} for line in open(d / "metrics.jsonl")]
    assert rows(tmp_path / "a") == rows(tmp_path / "b")


def _diverging(gan, at_step):
    """Wrap the trainer's step: from `at_step` on it poisons the generator
    and reports non-finite metrics."""
    gan._train_state()
    real = make_data_train_step(gan.state, latent_dim=K, batch_size=B,
                                disc_iters=DI)

    def step(data, gen):
        m = real(data, gen)
        if gan.state.step >= at_step:
            with torch.no_grad():
                gan.generator.fc_in.weight.fill_(float("nan"))
            m = dict(m, gp=torch.tensor(float("nan")))
        return m
    gan._train_step = step


def test_divergence_restores_the_latest_checkpoint(tmp_path):
    gan = DefenseGAN(_cfg(tmp_path, save_every=2, sample_every=0),
                     device="cpu")
    _diverging(gan, at_step=3)
    seed0 = gan._train_gen.initial_seed()
    out = gan.train(_data(), train_iters=4, log_every=1, quiet=True)
    # steps 3 and 4 diverged: each time the checkpoint of step 2 came back
    # and the draws were reseeded; the last finite metrics (step 2's) are
    # returned, and nothing non-finite was logged or saved
    logged = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in logged] == [1, 2]
    assert out["gp"] == logged[-1]["gp"]
    assert gan.state.step == gan.step == 2
    assert gan._train_gen.initial_seed() != seed0
    assert all(torch.isfinite(p).all() for p in gan.generator.parameters())
    assert latest_step(str(tmp_path)) == 2
    assert all(torch.isfinite(p).all() for p in DefenseGAN(
        _cfg(tmp_path), device="cpu").load().generator.parameters())


def test_divergence_raises_when_asked(tmp_path):
    gan = DefenseGAN(_cfg(tmp_path), device="cpu")
    _diverging(gan, at_step=1)
    with pytest.raises(RuntimeError, match="diverged at step 1"):
        gan.train(_data(), train_iters=2, log_every=1, quiet=True,
                  on_divergence="raise")
    # restore with nothing to restore from raises as well
    gan2 = DefenseGAN(_cfg(tmp_path / "fresh"), device="cpu")
    _diverging(gan2, at_step=1)
    with pytest.raises(RuntimeError, match="diverged"):
        gan2.train(_data(), train_iters=2, log_every=1, quiet=True)
