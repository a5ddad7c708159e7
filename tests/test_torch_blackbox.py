"""PyTorch port vs JAX: the black-box substitute pipeline
(defensegan_torch/attacks/blackbox.py) on the CPU.

  - jacobian_augmentation against JAX's, classifiers A (conv) and E
    (dense) loaded from the same flax weights, lmbda -0.1 and +0.1: every
    element equal (atol 1e-6) wherever JAX's input gradient is farther
    than 1e-6 of its largest element from 0; closer to 0 the sign is the
    rounding's, and at most 0.1% of the elements may differ there;
  - the growth schedule with the trainer stubbed on both sides (a fixed
    classifier): the same set sizes, the same oracle labels each round,
    the same sets (the sign rule lmbda (2 [rho // 3 != 0] - 1), and the
    capped growth through np.random.RandomState(rho) index for index);
  - persistent rounds (one module, trained on from its current weights
    each round) against from-scratch rounds (a fresh seeded module each
    round): round 0 is the same in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import defensegan_torch.attacks.blackbox as port_bb
import defensegan_tpu.attacks.blackbox as jax_bb
from defensegan_tpu.eval.classifier import ClassifierState as JaxState
from defensegan_tpu.models import build_classifier as jax_classifier
from defensegan_torch.attacks.blackbox import (jacobian_augmentation,
                                               train_substitute)
from defensegan_torch.ckpt.bridge import load_flax_tree
from defensegan_torch.eval.classifier import (ClassifierState,
                                              make_logits_fn)
from defensegan_torch.models import build_classifier

torch.set_num_threads(2)


def _pair(name, seed):
    jm = jax_classifier(name)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: jm.init(k, jnp.zeros((1, 28, 28, 1)), train=False))(
        jax.random.key(seed))["params"])
    tm = load_flax_tree(build_classifier(name), params).requires_grad_(False)
    return jm, params, tm


def _jax_logits(jm, params):
    return jax.jit(lambda x: jm.apply({"params": params}, x, train=False))


def test_jacobian_augmentation_linear_formula():
    """logits = x W: d Z_y / dx = W[:, y], so x' = clip(x + lmbda
    sign(W[:, y]))."""
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randn(784, 10).astype(np.float32))
    x = torch.from_numpy(rng.rand(3, 28, 28, 1).astype(np.float32))
    y = torch.tensor([1, 4, 7])
    out = jacobian_augmentation(lambda xx: xx.reshape(3, -1) @ w, x, y, 0.1)
    ref = torch.clamp(x + 0.1 * torch.sign(w[:, y].T.reshape(x.shape)),
                      0.0, 1.0)
    assert torch.allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("lmbda", [-0.1, 0.1])
@pytest.mark.parametrize("name", ["A", "E"])
def test_jacobian_augmentation_matches_jax(name, lmbda):
    jm, params, tm = _pair(name, 1)
    rng = np.random.RandomState(2)
    x = rng.rand(16, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, 16)
    jlogits = _jax_logits(jm, params)
    ref = np.asarray(jax_bb.jacobian_augmentation(
        jlogits, jnp.asarray(x), jnp.asarray(y), lmbda))
    got = jacobian_augmentation(make_logits_fn(tm), torch.from_numpy(x),
                                torch.from_numpy(y), lmbda).numpy()
    g = np.asarray(jax.grad(lambda xx: jnp.sum(jnp.take_along_axis(
        jlogits(xx), jnp.asarray(y)[:, None], 1)))(jnp.asarray(x)))
    firm = np.abs(g) > 1e-6 * np.abs(g).max()
    np.testing.assert_allclose(got[firm], ref[firm], atol=1e-6)
    assert np.mean(np.abs(got - ref) > 1e-6) <= 1e-3


def test_growth_schedule_matches_jax(monkeypatch):
    """Both trainers stubbed (a fixed substitute): 10 seeds, 6 rounds, a
    cap of 50, so the set grows 10 -> 20 -> 40 -> 50 (10 of the 40 drawn by
    RandomState(2)) and then refines on oracle labels only."""
    jo, po, to = _pair("E", 3)              # the oracle
    js, ps, ts = _pair("E", 4)              # the (fixed) substitute
    jax_calls, port_calls = [], []

    def jax_stub(model, x, y, **kw):
        jax_calls.append((np.array(x), np.array(y)))
        return JaxState(params=ps, model=js)

    def port_stub(model, x, y, **kw):
        port_calls.append((np.array(x), np.array(y)))
        return ClassifierState(ts)

    monkeypatch.setattr(jax_bb, "train_classifier", jax_stub)
    monkeypatch.setattr(port_bb, "train_classifier", port_stub)
    seed_x = np.random.RandomState(5).rand(10, 28, 28, 1).astype(np.float32)
    _, jx = jax_bb.train_substitute(js, _jax_logits(jo, po), seed_x,
                                    key=jax.random.key(0), data_aug=6,
                                    lmbda=0.1, max_set_size=50)
    _, tx = train_substitute(lambda s: ts, make_logits_fn(to), seed_x,
                             seed=0, data_aug=6, lmbda=0.1,
                             max_set_size=50)
    sizes = [c[0].shape[0] for c in port_calls]
    assert sizes == [c[0].shape[0] for c in jax_calls] \
        == [10, 20, 40, 50, 50, 50]
    assert tx.shape == jx.shape == (50, 28, 28, 1)
    for (xa, ya), (xb, yb) in zip(port_calls, jax_calls):
        np.testing.assert_array_equal(ya, yb)
    np.testing.assert_allclose(tx[:10], seed_x)
    diff = np.abs(tx - jx) > 1e-6
    assert diff.mean() <= 1e-3
    # rounds 0-2 step against the gradient sign (lmbda < 0): the new rows
    # of round 0 moved by -0.1 wherever they were not clipped
    step = tx[10:20] - tx[:10]
    moved = (tx[10:20] > 0.0) & (tx[10:20] < 1.0)
    assert np.allclose(np.abs(step[moved]), 0.1, atol=1e-6)


def test_persistent_and_from_scratch_rounds(monkeypatch):
    """The persistent substitute is built once and trained on every round
    from the weights the last round left; from scratch builds a freshly
    seeded one each round. Round 0 is the same in both."""
    _, _, oracle = _pair("E", 6)
    x_seed = np.random.RandomState(7).rand(16, 28, 28, 1).astype(
        np.float32)
    starts = []
    real = port_bb.train_classifier

    def recording(model, x, y, **kw):
        starts.append({k: v.clone() for k, v in model.state_dict().items()})
        return real(model, x, y, **kw)
    monkeypatch.setattr(port_bb, "train_classifier", recording)

    def run(persistent, rounds):
        built = []

        def make_sub(seed):
            built.append(seed)
            return build_classifier(
                "E", gen=torch.Generator().manual_seed(seed % 2 ** 31))
        starts.clear()
        state, x_sub = train_substitute(
            make_sub, make_logits_fn(oracle), x_seed, seed=11,
            data_aug=rounds, epochs_per_round=1, batch_size=8,
            persistent=persistent)
        return state, x_sub, built, list(starts)

    p_state, p_x, p_built, p_starts = run(True, 3)
    s_state, s_x, s_built, s_starts = run(False, 3)
    assert len(p_built) == 1 and len(s_built) == 3
    assert len(set(s_built)) == 3 and s_built[0] == p_built[0]
    assert p_x.shape == s_x.shape == (64, 28, 28, 1)
    # persistent: round rho + 1 starts where round rho ended
    assert all(not torch.equal(p_starts[0][k], p_starts[1][k])
               for k in p_starts[0])
    # from scratch: every round starts from its own fresh init
    assert all(not torch.equal(s_starts[1][k], p_starts[1][k])
               for k in s_starts[1])
    # round 0 is the same in both modes
    one_p = run(True, 1)[0].model.state_dict()
    one_s = run(False, 1)[0].model.state_dict()
    assert all(torch.equal(one_p[k], one_s[k]) for k in one_p)
    assert not all(torch.equal(p_state.model.state_dict()[k],
                               s_state.model.state_dict()[k])
                   for k in one_p)
