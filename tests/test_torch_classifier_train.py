"""PyTorch port vs JAX: classifier training (defensegan_torch/eval/
classifier.py) and the zoo's training mode (models/classifiers.py) on the
CPU.

For each of the zoo's models A-F, with the same weights through
ckpt/bridge.py and the same seeded batch:
  - the training-mode forward with dropout off equals flax's
    apply(train=False): rtol 1e-5 / atol 1e-5 on the logits (float32
    summation order);
  - one Adam step (1e-3, the optax defaults) on the cross-entropy, dropout
    off, gives optax's parameters: atol 2e-6 where optax's gradient
    element is 0 or at least 1e-6 in magnitude. The first step moves a
    weight by lr * g / (|g| + 1e-8); where 0 < |g| < 1e-6 that ratio turns
    on the last float32 bits of g (a few elements in a million, at |g|
    from 1e-8 to 1.4e-7), and there the weights agree within lr = 1e-3,
    the most one step can move them;
  - the same with FGSM adversarial training (adv_eps 0.3).
Dropout masks cannot match across frameworks; their placement and rates
are held against the JAX zoo's (0.25 / 0.5 / 0.2) and their statistics
checked. The classifier cache round-trips through torch checkpoints under
output/classifiers_torch/.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from defensegan_tpu.models import build_classifier as jax_classifier
from defensegan_torch.ckpt.bridge import load_flax_tree
from defensegan_torch.eval.classifier import (ClassifierState, cache_dir,
                                              load_cached_classifier,
                                              make_logits_fn,
                                              make_train_step,
                                              save_classifier,
                                              train_classifier)
from defensegan_torch.models import CLASSIFIER_ZOO, build_classifier

torch.set_num_threads(2)

ZOO = list(CLASSIFIER_ZOO)


def _pair(name, seed=0):
    jm = jax_classifier(name)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(seed), jnp.zeros((1, 28, 28, 1)), train=False)[
        "params"])
    tm = load_flax_tree(build_classifier(name), params)
    return jm, params, tm


def _batch(seed=0, b=8):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, 28, 28, 1).astype(np.float32),
            rng.randint(0, 10, b).astype(np.int32))


def _jax_xent(logits, y):
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))


def _jax_step(jm, params, x, y, adv_eps=None):
    """One step of JAX's train_classifier with dropout off (train=False)."""
    tx = optax.adam(1e-3)
    opt = tx.init(params)
    xb = jnp.asarray(x)
    yb = jnp.asarray(y)
    if adv_eps is not None:
        g = jax.grad(lambda xx: _jax_xent(jm.apply({"params": params}, xx,
                                                   train=False), yb))(xb)
        xb_adv = jnp.clip(xb + adv_eps * jnp.sign(g), 0.0, 1.0)

    def loss_fn(p):
        loss = _jax_xent(jm.apply({"params": p}, xb, train=False), yb)
        if adv_eps is not None:
            loss = 0.5 * loss + 0.5 * _jax_xent(
                jm.apply({"params": p}, xb_adv, train=False), yb)
        return loss

    grads = jax.grad(loss_fn)(params)
    upd, _ = tx.update(grads, opt, params)
    return (jax.tree.map(np.asarray, optax.apply_updates(params, upd)),
            jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("name", ZOO)
def test_train_forward_without_dropout_matches_flax(name):
    jm, params, tm = _pair(name)
    x, _ = _batch(1)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                              train=False))
    got = tm(torch.from_numpy(x), dropout=None).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("adv_eps", [None, 0.3])
@pytest.mark.parametrize("name", ZOO)
def test_one_adam_step_matches_optax(name, adv_eps):
    jm, params, tm = _pair(name, seed=2)
    x, y = _batch(3)
    ref, refg = build_classifier(name), build_classifier(name)
    new_params, grads = _jax_step(jm, params, x, y, adv_eps)
    load_flax_tree(ref, new_params)
    load_flax_tree(refg, grads)         # optax's gradient, port layout
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3, eps=1e-8)
    make_train_step(tm, opt, adv_eps)(torch.from_numpy(x),
                                      torch.from_numpy(y), None)
    n_firm = n_all = 0
    for (k, a), (_, b), (_, g) in zip(tm.state_dict().items(),
                                      ref.state_dict().items(),
                                      refg.state_dict().items()):
        a, b, g = a.numpy(), b.numpy(), g.numpy()
        firm = (np.abs(g) >= 1e-6) | (g == 0)
        np.testing.assert_allclose(a[firm], b[firm], atol=2e-6, rtol=0,
                                   err_msg=k)
        np.testing.assert_allclose(a, b, atol=1e-3 + 1e-7, rtol=0,
                                   err_msg=k)
        n_firm += int(firm.sum())
        n_all += firm.size
    assert n_firm > 0.99 * n_all
    # the step moved the weights (by up to lr)
    moved = max(float((a - p).abs().max()) for a, p in zip(
        tm.state_dict().values(), _pair(name, seed=2)[2].state_dict()
        .values()))
    assert 5e-4 < moved <= 1.1e-3


DROP_RATES = {"A": [0.25, 0.5], "B": [0.2, 0.5], "C": [0.25, 0.5],
              "D": [0.5, 0.5, 0.5], "E": [], "F": []}


@pytest.mark.parametrize("name", ZOO)
def test_dropout_placement_and_rates(name):
    """The JAX zoo's Dropout layers, in order, at its rates; a model with
    none gives the inference forward in training mode."""
    jm, params, tm = _pair(name)
    x, _ = _batch(4)
    # flax's train-mode forward differs from its inference forward only
    # through its Dropout layers
    xj = jnp.asarray(x)
    j_train = jm.apply({"params": params}, xj, train=True,
                       rngs={"dropout": jax.random.key(0)})
    j_has_dropout = not np.allclose(np.asarray(j_train), np.asarray(
        jm.apply({"params": params}, xj, train=False)))
    rates = [spec[1] for spec in tm.plan if isinstance(spec, tuple)]
    assert rates == DROP_RATES[name] and bool(rates) == j_has_dropout
    gen = torch.Generator().manual_seed(0)
    xt = torch.from_numpy(x)
    train = tm(xt, dropout=gen)
    if rates:
        assert not torch.allclose(train, tm(xt))
        # masks come from the generator: same state, same masks
        again = tm(xt, dropout=torch.Generator().manual_seed(0))
        torch.testing.assert_close(train, again, rtol=0, atol=0)
    else:
        torch.testing.assert_close(train, tm(xt), rtol=0, atol=0)


def test_dropout_keeps_the_expected_value():
    """flax semantics: keep with probability 1 - rate, scale by 1/keep."""
    tm = build_classifier("D", gen=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name in ("Dense_0", "Dense_1", "Dense_2", "Dense_3"):
            layer = getattr(tm, name)
            layer.weight.copy_(torch.eye(*layer.weight.shape))
            layer.bias.zero_()
    x = torch.ones(4000, 28, 28, 1)
    with torch.no_grad():
        out = tm(x, dropout=torch.Generator().manual_seed(1))
    # through three Drop(0.5) layers one unit survives with p = 1/8 and
    # is scaled by 8: mean 1, zeros 7/8
    assert abs(float(out.mean()) - 1.0) < 0.05
    assert abs(float((out == 0).float().mean()) - 7 / 8) < 0.02


def test_train_classifier_learns_and_is_deterministic(tmp_path,
                                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(0)
    protos = rng.rand(3, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 3, 512).astype(np.int32)
    x = np.clip(protos[y] + 0.1 * rng.randn(512, 28, 28, 1), 0, 1) \
        .astype(np.float32)
    runs = []
    for _ in range(2):
        m = build_classifier("A", num_classes=3,
                             gen=torch.Generator().manual_seed(0))
        runs.append(train_classifier(m, x, y, seed=5, epochs=2,
                                     batch_size=64))
    a, b = (r.model.state_dict() for r in runs)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    logits = runs[0].logits_fn()(torch.from_numpy(x))
    assert float((logits.argmax(-1).numpy() == y).mean()) > 0.9
    assert not any(p.requires_grad for p in runs[0].model.parameters())
    with pytest.raises(ValueError, match="out of range"):
        train_classifier(build_classifier("E", num_classes=3), x,
                         np.full(512, 3, np.int32), seed=0, epochs=1)
    # adversarial training runs and differs from plain training
    m = build_classifier("A", num_classes=3,
                         gen=torch.Generator().manual_seed(0))
    adv = train_classifier(m, x, y, seed=5, epochs=1, batch_size=64,
                           adv_eps=0.3)
    assert not torch.equal(adv.model.Dense_0.weight, a["Dense_0.weight"])


def test_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    m = build_classifier("C", gen=torch.Generator().manual_seed(3))
    assert load_cached_classifier("t", build_classifier("C")) is None
    path = save_classifier("t", ClassifierState(m))
    assert path.startswith(str(tmp_path / cache_dir("t")))
    assert cache_dir("t") == "output/classifiers_torch/t"
    fresh = load_cached_classifier("t", build_classifier("C"))
    x = torch.rand(3, 28, 28, 1)
    torch.testing.assert_close(fresh.logits_fn()(x),
                               make_logits_fn(m)(x), rtol=0, atol=0)
    assert not (tmp_path / "output" / "classifiers").exists()
