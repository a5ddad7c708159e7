"""PyTorch port vs JAX: the single-device entry point (graft_entry_torch.py
against __graft_entry__.py) on the CPU.

JAX's entry() gives the flagship forward step and its example; its flax
weights go across through params_from_flax, and its x and z0 as numpy
arrays (the two frameworks draw different streams, so nothing is sampled
on both sides). Then the port's fn and jax.jit(fn) run at the entry's own
settings: batch 4, R 10, L 200, the dim-64 deep generator.

Bounds: x_hat within 2e-3 in image space (measured: 7.8e-4, over an
output range of 0.25 to 0.76; float32 summation order carried through 200
momentum steps at lr 10, where tests/test_torch_project.py holds 1e-3 at
L 6). fn returns only x_hat, so the full results from the same weights
and inputs are held too: argmins equal and all_losses within rtol 1e-3
(measured: 5.2e-4). Row 1's two best restarts end 3.4e-4 apart (0.2983
and 0.2987), so a flipped argmin shows here by name, not inside the x_hat
bound.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import __graft_entry__ as jax_entry  # noqa: E402
import graft_entry_torch as ge  # noqa: E402
import multichip_torch  # noqa: E402
from defensegan_torch.models import generator_for  # noqa: E402

torch.set_num_threads(2)

X_HAT_ATOL = 2e-3
LOSS_RTOL = 1e-3


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """JAX's entry, its x_hat under jax.jit and its full result, beside the
    port's fn on the carried weights and JAX's x and z0."""
    from defensegan_tpu.configs import Config as JaxConfig
    from defensegan_tpu.defense import reconstruct as jax_reconstruct
    from defensegan_tpu.models import generator_for as jax_generator

    fn, (params, stats, x, z0) = jax_entry.entry()
    ref_x_hat = np.asarray(jax.jit(fn)(params, stats, x, z0))
    cfg = JaxConfig(type="mnist")
    gen = jax_generator(cfg.type, cfg.gen_dim)

    def full(params, stats, x, z0):
        def gen_apply(z):
            return gen.apply({"params": params, "batch_stats": stats}, z,
                             train=False)
        return jax_reconstruct(gen_apply, x, z0, rec_iters=cfg.rec_iters,
                               rec_lr=cfg.rec_lr, momentum=cfg.rec_momentum)

    ref = jax.jit(full)(params, stats, x, z0)
    tparams, tstats = ge.params_from_flax(_numpy(params), _numpy(stats),
                                          device="cpu")
    tx, tz0 = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(z0))
    tfn, _ = ge.entry(device="cpu")
    return dict(ref_x_hat=ref_x_hat, ref=ref, params=tparams, stats=tstats,
                x=tx, z0=tz0, x_hat=tfn(tparams, tstats, tx, tz0))


def test_fn_matches_jax_entry_on_its_weights(pair):
    got, ref = pair["x_hat"], pair["ref_x_hat"]
    assert tuple(got.shape) == ref.shape == (4, 28, 28, 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=X_HAT_ATOL)


def test_full_result_matches_jax_restart_by_restart(pair):
    """fn's projection with every restart's final loss (project): argmins
    equal, all_losses within rtol 1e-3, and x_hat equal to fn's."""
    got = ge.project(pair["params"], pair["stats"], pair["x"], pair["z0"])
    ref_losses = np.asarray(pair["ref"].all_losses)
    assert got.all_losses.shape == ref_losses.shape == (4, 10)
    np.testing.assert_array_equal(got.all_losses.numpy().argmin(1),
                                  ref_losses.argmin(1))
    np.testing.assert_allclose(got.all_losses.numpy(), ref_losses,
                               rtol=LOSS_RTOL)
    torch.testing.assert_close(got.x_hat, pair["x_hat"], rtol=0, atol=0)


def test_params_from_flax_refuses_a_missing_or_extra_layer():
    from defensegan_tpu.configs import Config as JaxConfig
    from defensegan_tpu.models import generator_for as jax_generator

    cfg = JaxConfig(type="mnist")
    v = jax_generator(cfg.type, cfg.gen_dim).init(
        jax.random.key(0), np.zeros((1, cfg.latent_dim), np.float32),
        train=True)
    params, stats = _numpy(v["params"]), _numpy(v["batch_stats"])
    ge.params_from_flax(params, stats, device="cpu")
    missing = {k: p for k, p in params.items() if k != "deconv_out"}
    with pytest.raises(KeyError):
        ge.params_from_flax(missing, stats, device="cpu")
    extra = dict(params, deconv_1=params["deconv_0"])
    with pytest.raises(KeyError):
        ge.params_from_flax(extra, stats, device="cpu")


def test_entry_contract_on_the_cpu():
    """The counterpart of the JAX package's own check of entry(): shape
    (4, 28, 28, 1) and finite."""
    fn, args = ge.entry(device="cpu")
    params, stats, x, z0 = args
    out = fn(*args)
    assert tuple(out.shape) == (4, 28, 28, 1) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    assert 0.0 <= float(out.min()) and float(out.max()) <= 1.0
    assert tuple(x.shape) == (4, 28, 28, 1) and tuple(z0.shape) == \
        (4, 10, 128)
    assert 0.0 <= float(x.min()) and float(x.max()) < 1.0
    gen = generator_for("mnist", 64, latent_dim=128)
    shapes = {n: tuple(t.shape) for n, t in gen.named_parameters()}
    assert {n: tuple(t.shape) for n, t in params.items()} == shapes
    buffers = {n: tuple(t.shape) for n, t in gen.named_buffers()}
    assert {n: tuple(t.shape) for n, t in stats.items()} == buffers
    assert all(t.device.type == "cpu" for t in
               list(params.values()) + list(stats.values()) + [x, z0])
    # the same seeds on every call
    _, again = ge.entry(device="cpu")
    for a, b in zip(args[2:], again[2:]):
        assert torch.equal(a, b)


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ge.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ge.params_from_flax({}, {})


def test_dryrun_is_multichip_torchs(monkeypatch):
    assert ge.dryrun_multichip is multichip_torch.dryrun_multichip
    calls = []
    monkeypatch.setattr(multichip_torch, "dryrun_multichip",
                        lambda n, device: calls.append((n, device)))
    assert ge.main(["4", "--device", "cpu"]) == 0
    assert calls == [(4, "cpu")]
