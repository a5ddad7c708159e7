"""PyTorch port vs JAX: the white-box attack suite (defensegan_torch/attacks/)
on the CPU.

The same classifier weights (through ckpt/bridge.py), x, labels, and the
random draws each attack makes (made with JAX's keys and passed to the
port) go through both packages, in float32. Tolerances, each stated
where it is used:

  - FGSM: equal, except where JAX's |d loss / dx| < 1e-7, where float32
    summation order may flip the sign;
  - RAND+FGSM: equal the same way, with JAX's noise;
  - PGD (3 steps, JAX's rand_init noise): at most 1% of the elements
    differ, by at most nb_iter * eps_iter (a sign flip of a near-zero
    gradient element in one step), the rest equal to 1e-6;
  - SPSA (2 iterations, JAX's Rademacher draws): atol 1e-5 (Adam on the
    perturbation, lr 0.01; float32 summation order of the estimate);
  - CW-L2 (2 binary-search steps x 5 iterations): against JAX atol 1e-4,
    the chunked attack against the unchunked one exactly;
  - exact and BPDA targets through a tiny defense (R 2, L 3), with
    eot_over_keys, and the detection-aware loss with and without
    rec_center: values rtol 1e-4, d/dx atol 1e-5 + 1e-3 of its largest
    element (the back_prop tolerance of test_torch_backprop.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.attacks.compose import eot_over_keys as jax_eot
from defensegan_tpu.attacks.compose import make_attack_loss as jax_loss
from defensegan_tpu.attacks.compose import \
    make_attack_target as jax_target
from defensegan_tpu.configs import Config as JaxConfig
from defensegan_tpu.defense.project import sample_z0 as jax_sample_z0
from defensegan_tpu.gan import DefenseGAN as JaxGAN
from defensegan_tpu.models import build_classifier as jax_classifier
from defensegan_torch.attacks import (CWConfig, attack_batch_key,
                                      attack_z0_key, carlini_wagner_l2,
                                      carlini_wagner_l2_chunked,
                                      confident_margin_loss,
                                      effective_cw_chunk, eot_over_keys,
                                      fgsm, fold_seed, make_attack_loss,
                                      make_attack_target, make_chunked_cw,
                                      make_chunked_pgd, make_spsa,
                                      margin_loss, pgd, rand_fgsm,
                                      split_rand_fgsm_key)
from defensegan_torch.ckpt.bridge import load_flax_tree
from defensegan_torch.configs import Config
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.models import build_classifier

# the JAX attack modules (the package re-exports functions of the same
# names as two of them)
jax_cw, jax_fgsm, jax_pgd, jax_spsa = (
    importlib.import_module(f"defensegan_tpu.attacks.{m}")
    for m in ("cw", "fgsm", "pgd", "spsa"))

torch.set_num_threads(2)

B = 6


def _clf_pair(name="E", seed=0):
    jm = jax_classifier(name)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(seed), jnp.zeros((1, 28, 28, 1)))["params"])
    tm = load_flax_tree(build_classifier(name), params).requires_grad_(False)

    def jax_logits(x):
        return jm.apply({"params": params}, x, train=False)
    return jax_logits, tm


def _data(seed=0, b=B):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, b).astype(np.int32)
    return x, y


def _t(a):
    return torch.from_numpy(np.array(a))


def _equal_off_small_grads(got, ref, x, g_ref):
    keep = np.abs(np.asarray(g_ref)) >= 1e-7
    assert keep.mean() > 0.5
    np.testing.assert_allclose(got[keep], np.asarray(ref)[keep], atol=1e-6)


@pytest.mark.parametrize("name", ["A", "E"])
def test_fgsm_matches_jax(name):
    jl, tm = _clf_pair(name)
    x, y = _data(1)
    ref = jax_fgsm.fgsm(jl, jnp.asarray(x), jnp.asarray(y), 0.3)
    g = jax.grad(lambda xx: jnp.mean(jax_fgsm._xent(jl(xx),
                                                    jnp.asarray(y))))(
        jnp.asarray(x))
    got = fgsm(tm, _t(x), _t(y), 0.3).numpy()
    _equal_off_small_grads(got, ref, x, g)
    tgt = fgsm(tm, _t(x), _t(y), 0.3, targeted=True).numpy()
    ref_t = jax_fgsm.fgsm(jl, jnp.asarray(x), jnp.asarray(y), 0.3,
                          targeted=True)
    _equal_off_small_grads(tgt, ref_t, x, g)


def test_rand_fgsm_matches_jax_with_its_noise():
    jl, tm = _clf_pair("E")
    x, y = _data(2)
    key = jax.random.key(3)
    ref = jax_fgsm.rand_fgsm(jl, jnp.asarray(x), jnp.asarray(y), 0.3, 0.05,
                             key)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    x_rand = np.clip(x + 0.05 * np.sign(noise), 0, 1)
    g = jax.grad(lambda xx: jnp.mean(jax_fgsm._xent(jl(xx),
                                                    jnp.asarray(y))))(
        jnp.asarray(x_rand))
    got = rand_fgsm(tm, _t(x), _t(y), 0.3, 0.05, noise=_t(noise)).numpy()
    _equal_off_small_grads(got, ref, x, g)
    with pytest.raises(ValueError, match="alpha < eps"):
        rand_fgsm(tm, _t(x), _t(y), 0.1, 0.2)
    # drawn from a generator: deterministic per seed
    a = rand_fgsm(tm, _t(x), _t(y), 0.3, 0.05,
                  torch.Generator().manual_seed(0))
    b = rand_fgsm(tm, _t(x), _t(y), 0.3, 0.05,
                  torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("chunked", [False, True])
def test_pgd_matches_jax_with_its_init_noise(chunked):
    jl, tm = _clf_pair("A", seed=1)
    x, y = _data(3)
    key = jax.random.key(4)
    eps, eps_iter, n = 0.3, 0.05, 3
    ref = np.asarray(jax_pgd.pgd(jl, jnp.asarray(x), jnp.asarray(y), eps,
                                 eps_iter, n, key=key))
    init = np.asarray(jax.random.uniform(
        jax.random.fold_in(key, jax_pgd._INIT_FOLD), x.shape, jnp.float32,
        minval=-eps, maxval=eps))
    if chunked:
        got = make_chunked_pgd(tm, eps, eps_iter, n, chunk_iters=2)(
            _t(x), _t(y), init_noise=_t(init)).numpy()
    else:
        got = pgd(tm, _t(x), _t(y), eps, eps_iter, n,
                  init_noise=_t(init)).numpy()
    diff = np.abs(got - ref)
    assert (diff > 1e-6).mean() <= 0.01
    assert diff.max() <= n * eps_iter + 1e-6
    assert np.all(np.abs(got - x) <= eps + 1e-6)


def test_pgd_keyed_target_gets_per_step_keys():
    seen = []

    def target(x, key):
        seen.append(key)
        return x.reshape(x.shape[0], -1)[:, :10] * 3.0
    x, y = _data(4)
    pgd(target, _t(x), _t(y), 0.3, 0.01, 3, key=11, keyed_logits=True)
    assert seen == [fold_seed(11, i) for i in range(3)]
    seen.clear()
    pgd(target, _t(x), _t(y), 0.3, 0.01, 2, key=11, keyed_logits=True,
        per_step_keys=False, rand_init=False)
    assert seen == [11, 11]
    with pytest.raises(ValueError, match="keyed_logits"):
        pgd(target, _t(x), _t(y), 0.3, 0.01, 1, key=1,
            loss_fn=lambda a, b, c: a.sum((1, 2, 3)))


def test_spsa_matches_jax_with_its_draws():
    jl, tm = _clf_pair("E", seed=2)
    x, y = _data(5)
    key = jax.random.key(6)
    kw = dict(eps=0.3, nb_iter=2, n_samples=4, delta=0.01, lr=0.01,
              chunk_samples=2)

    def jloss(xf, yf, k):
        return jax_spsa.margin_loss(jl(xf), yf)
    ref = np.asarray(jax_spsa.make_spsa(jloss, **kw)(jnp.asarray(x),
                                                     jnp.asarray(y), key))

    def rademacher(t, ci, shape):
        kt = jax.random.fold_in(key, t)
        kv = jax.random.fold_in(kt, jax_spsa._FOLD_RADEMACHER + ci)
        return _t(np.asarray(jax.random.rademacher(kv, shape, jnp.float32)))

    def tloss(xf, yf, k):
        return margin_loss(tm(xf), yf)
    got = make_spsa(tloss, **kw)(_t(x), _t(y), 0,
                                 rademacher=rademacher).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert np.abs(got - x).max() > 1e-3          # it moved


def test_margin_losses_match_jax():
    rng = np.random.RandomState(7)
    logits = rng.randn(9, 10).astype(np.float32)
    y = rng.randint(0, 10, 9).astype(np.int32)
    np.testing.assert_allclose(
        margin_loss(_t(logits), _t(y)).numpy(),
        np.asarray(jax_spsa.margin_loss(jnp.asarray(logits),
                                        jnp.asarray(y))), rtol=1e-6)
    np.testing.assert_allclose(
        confident_margin_loss(_t(logits), _t(y)).numpy(),
        np.asarray(jax_spsa.confident_margin_loss(jnp.asarray(logits),
                                                  jnp.asarray(y))),
        rtol=1e-6)


def test_cw_matches_jax_and_chunked_equals_unchunked():
    jl, tm = _clf_pair("E", seed=3)
    x, _ = _data(8)
    # labels the classifier predicts, so that x itself is no success
    y = tm(_t(x)).argmax(-1).numpy().astype(np.int32)
    cfg = CWConfig(binary_search_steps=2, max_iterations=5,
                   learning_rate=0.1, initial_const=10.0)
    ref = np.asarray(jax_cw.carlini_wagner_l2(
        jl, jnp.asarray(x), jnp.asarray(y), jax_cw.CWConfig(*cfg)))
    got = carlini_wagner_l2(tm, _t(x), _t(y), cfg).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert np.abs(got - x).max() > 1e-3          # some example succeeded
    chunked = carlini_wagner_l2_chunked(tm, _t(x), _t(y), cfg,
                                        chunk_iters=2).numpy()
    np.testing.assert_array_equal(chunked, got)
    assert effective_cw_chunk(cfg, 100, True) == \
        jax_cw.effective_cw_chunk(jax_cw.CWConfig(*cfg), 100, True) == 1
    # abort_early stops a binary-search step at a plateau: the chunked
    # attacks of both packages agree on the result
    cfg10 = cfg._replace(max_iterations=20)
    ref_ae = np.asarray(jax_cw.make_chunked_cw(
        jl, jax_cw.CWConfig(*cfg10), abort_early=True)(jnp.asarray(x),
                                                       jnp.asarray(y)))
    got_ae = make_chunked_cw(tm, cfg10, abort_early=True)(_t(x),
                                                          _t(y)).numpy()
    np.testing.assert_allclose(got_ae, ref_ae, atol=1e-4)


# ----------------------------------------------------- through a defense
LATENT, RR, L = 16, 2, 3


@pytest.fixture(scope="module")
def defense(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("run"))
    kw = dict(type="mnist", gen_arch="wide", gen_dim=4, disc_dim=4,
              latent_dim=LATENT, rec_rr=RR, rec_iters=L,
              compute_dtype="float32", output_dir=out)
    jgan = JaxGAN(JaxConfig(**kw), key=jax.random.key(8))
    tgan = DefenseGAN(Config(**kw), device="cpu")
    load_flax_tree(tgan.generator,
                   jax.tree.map(np.asarray, jgan.state.gen_params),
                   jax.tree.map(np.asarray, jgan.state.gen_stats))
    jl, tm = _clf_pair("E", seed=4)
    return jgan, tgan, jl, tm


def _z0_table(keys_by_seed, b):
    """port seed -> JAX's z0 for the matching key."""
    table = {s: _t(np.asarray(jax_sample_z0(k, b, RR, LATENT)))
             for s, k in keys_by_seed.items()}
    return lambda x, key: table[key]


def _grad(f, x):
    xt = _t(x).requires_grad_(True)
    val = f(xt)
    (g,) = torch.autograd.grad(val.sum(), xt)
    return val.detach().numpy(), g.numpy()


def _close(got, ref):
    val, g = got
    rval, rg = ref
    np.testing.assert_allclose(val, np.asarray(rval), rtol=1e-4, atol=1e-6)
    rg = np.asarray(rg)
    np.testing.assert_allclose(g, rg, rtol=0,
                               atol=1e-5 + 1e-3 * np.abs(rg).max())


@pytest.mark.parametrize("grad_mode", ["exact", "bpda"])
@pytest.mark.parametrize("k_eot", [1, 3])
def test_defended_target_matches_jax(defense, grad_mode, k_eot):
    jgan, tgan, jl, tm = defense
    x, _ = _data(9, b=4)
    key = jax.random.key(10)
    jt = jax_eot(jax_target(jgan, jl, jgan.cfg, grad_mode=grad_mode),
                 k_eot)
    ref = (jt(jnp.asarray(x), key),
           jax.grad(lambda xx: jnp.sum(jt(xx, key)))(jnp.asarray(x)))
    if k_eot == 1:
        keys = {77: key}
    else:
        keys = dict(zip((fold_seed(77, j) for j in range(k_eot)),
                        jax.random.split(key, k_eot)))
    tt = eot_over_keys(make_attack_target(
        tgan, tm, tgan.cfg, grad_mode=grad_mode,
        z0_fn=_z0_table(keys, 4)), k_eot)
    _close(_grad(lambda xt: tt(xt, 77), x), ref)


@pytest.mark.parametrize("grad_mode", ["exact", "bpda"])
@pytest.mark.parametrize("center", [None, 0.03])
def test_detection_aware_loss_matches_jax(defense, grad_mode, center):
    jgan, tgan, jl, tm = defense
    x, y = _data(11, b=4)
    key = jax.random.key(12)
    jf = jax_loss(jgan, jl, jgan.cfg, grad_mode=grad_mode, rec_penalty=5.0,
                  rec_center=center)
    ref = (jf(jnp.asarray(x), jnp.asarray(y), key),
           jax.grad(lambda xx: jnp.sum(jf(xx, jnp.asarray(y), key)))(
               jnp.asarray(x)))
    tf = make_attack_loss(tgan, tm, tgan.cfg, grad_mode=grad_mode,
                          rec_penalty=5.0, rec_center=center,
                          z0_fn=_z0_table({5: key}, 4))
    _close(_grad(lambda xt: tf(xt, _t(y), 5), x), ref)


def test_defended_target_draws_its_z0_from_the_key(defense):
    """Without z0_fn the restarts come from a generator seeded with the
    key: the same key gives the same logits, another key others."""
    _, tgan, _, tm = defense
    x, _ = _data(13, b=2)
    t = make_attack_target(tgan, tm, tgan.cfg, grad_mode="bpda")
    a, b, c = t(_t(x), 1), t(_t(x), 1), t(_t(x), 2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    with pytest.raises(ValueError, match="grad_mode"):
        make_attack_target(tgan, tm, tgan.cfg, grad_mode="nope")


def test_key_rules_give_distinct_streams():
    k = 123
    batch = {attack_batch_key(k, lo) for lo in range(0, 640, 64)}
    assert len(batch) == 10
    kz, kn = split_rand_fgsm_key(attack_batch_key(k, 64))
    assert kz != kn
    assert attack_z0_key(k, 64, "rand_fgsm") == kz
    assert attack_z0_key(k, 64, "fgsm") == attack_batch_key(k, 64)
    assert fold_seed(k, 1) == fold_seed(k, 1) != fold_seed(k, 2)
    assert 0 <= fold_seed(2 ** 62, 2 ** 40) < 2 ** 63
