"""PyTorch port vs JAX: the data-parallel train steps
(defensegan_torch/parallel/distributed.py, gan/train.py under a process
group, DefenseGAN.train and train_torch.py --is_train under a group) on two
gloo ranks on the CPU.

The ranks are spawned once for the module (tests/torch_parallel_workers.py
::dp_ranks); the JAX references run here on the 8-virtual-device mesh.
Weights: the deep MNIST generator and critic at GEN_DIM / DISC_DIM 4,
LATENT_DIM 16, float32, flax-initialized; B 8 a rank, disc_iters 2.

Tolerances:
  - the explicit DP step against JAX's make_shard_map_train_step on
    make_mesh(2), each rank handed JAX's per-shard draws (fold_in(key,
    shard), then JAX's splits): as tests/test_torch_gan_train.py, metrics
    rtol 1e-5 / atol 1e-6, the running statistics within 1e-6, the
    parameters in lr units; every rank's weights equal bit for bit;
  - the global-batch step (the data step under the group, on JAX's global
    draws) and DefenseGAN.train under the group: against the port's
    single-process step on the global batch and against JAX's GSPMD step,
    within tests/test_parallel.py's rtol 2e-4 / atol 2e-4 (metrics) and
    rtol 2e-3 / atol 2e-4 (parameters); a deconv bias before a BatchNorm
    (exact gradient 0, stepped by rounding noise) within 2 lr a step.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.gan.train import make_data_train_step as jax_data_step
from defensegan_tpu.parallel import global_batch_sharding
from defensegan_tpu.parallel import make_mesh as jax_make_mesh
from defensegan_tpu.parallel import make_shard_map_train_step, \
    replicated_sharding
from defensegan_torch.ckpt.bridge import flax_tree
from defensegan_torch.configs import Config
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.gan.train import init_gan_state, make_data_train_step
from defensegan_torch.parallel import initialize_distributed, spawn_group
from test_torch_gan_train import (DI, K, LR, _assert_params_in_lr_units,
                                  _data, _exact_zero, _jax_state, _np,
                                  _port_modules, jax_draws)
from torch_parallel_workers import dp_ranks

WORLD = 2
B_GLOBAL = 8 * WORLD
CLI_CFG = str(pathlib.Path(__file__).resolve().parents[1] / "defensegan_torch"
              / "configs" / "gans" / "mnist_fast.yml")
CLI_TINY = ["--device", "cpu", "--batch_size", str(B_GLOBAL),
            "--override", "GEN_DIM=4", "--override", "DISC_DIM=4",
            "--override", "LATENT_DIM=16", "--override", "DISC_ITERS=2",
            "--override", "COMPUTE_DTYPE=float32", "--override",
            "SAVE_EVERY=2", "--override", "SAMPLE_EVERY=2"]
CFG = dict(type="mnist", gen_arch="deep", gen_dim=4, disc_dim=4,
           latent_dim=K, batch_size=B_GLOBAL, disc_iters=DI,
           compute_dtype="float32", save_every=2, sample_every=0, seed=3)


def _shard_draws(key, n_shards, b_local):
    """JAX's shard_map step draws: per shard fold_in(key, shard), then
    (k_disc, k_gen), disc_iters critic keys, each split into (kz, ke)."""
    out = []
    for i in range(n_shards):
        k_disc, k_gen = jax.random.split(jax.random.fold_in(key, i))
        zs, es = [], []
        for k in jax.random.split(k_disc, DI):
            kz, ke = jax.random.split(k)
            zs.append(jax.random.normal(kz, (b_local, K), jnp.float32))
            es.append(jax.random.uniform(ke, (b_local,), jnp.float32))
        zg = jax.random.normal(k_gen, (b_local, K), jnp.float32)
        out.append((np.array(jnp.stack(zs)), np.array(jnp.stack(es)),
                    np.array(zg), None))
    return out


def _tree(d):
    return tuple(None if t is None else t.numpy() for t in d)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jg, jc, gtx, dtx, st = _jax_state()
    trees = dict(gen_params=_np(st.gen_params), gen_stats=_np(st.gen_stats),
                 disc_params=_np(st.disc_params))
    mesh = jax_make_mesh(2)
    rep = replicated_sharding(mesh)
    # JAX's explicit step on make_mesh(2)
    real = np.random.RandomState(4).rand(DI, B_GLOBAL, 28, 28, 1) \
        .astype(np.float32)
    key = jax.random.key(21)
    sm = make_shard_map_train_step(jg, jc, gtx, dtx, latent_dim=K,
                                   disc_iters=DI, mesh=mesh)
    sm_state, sm_m = sm(jax.device_put(st, rep), jax.device_put(
        jnp.asarray(real), global_batch_sharding(mesh)), key)
    # JAX's GSPMD data step on the global batch
    data = _data()
    gkey = jax.random.key(33)
    dstep = jax_data_step(jg, jc, gtx, dtx, latent_dim=K,
                          batch_size=B_GLOBAL, disc_iters=DI)
    g_state, g_m = jax.jit(lambda s, d, k: dstep(s, d, k, mesh=mesh))(
        jax.device_put(st, rep), jax.device_put(jnp.asarray(data), rep),
        gkey)
    global_draws = jax_draws(gkey, batch=B_GLOBAL)
    # the port's single-process step on the same global batch and draws
    tg, tc = _port_modules(st)
    state = init_gan_state(tg, tc)
    pm = make_data_train_step(state, latent_dim=K, batch_size=B_GLOBAL,
                              disc_iters=DI)(torch.from_numpy(data), None,
                                             global_draws)
    gp, gs = flax_tree(tg)
    single = dict(metrics={k: float(v) for k, v in pm.items()}, gen=gp,
                  stats=gs, disc=flax_tree(tc)[0])
    # the port's single-process trainer
    solo_dir = tmp_path_factory.mktemp("solo")
    solo = DefenseGAN(Config(output_dir=str(solo_dir), **CFG), device="cpu")
    solo_m = solo.train(data, train_iters=2, log_every=1, quiet=True)
    sgp, sgs = flax_tree(solo.generator)
    solo_out = dict(metrics=solo_m, gen=sgp, stats=sgs,
                    disc=flax_tree(solo.critic)[0])
    # the training CLI, alone and under the group
    from defensegan_torch.cli.train import main as train_cli
    cli_dirs = [tmp_path_factory.mktemp(n) / "run" for n in ("cli", "gcli")]
    cli_args = [["--cfg", CLI_CFG, "--is_train", "--output_dir", str(d),
                 "--train_iters", "2"] + CLI_TINY for d in cli_dirs]
    cli_solo = train_cli(cli_args[0])
    group_dir = tmp_path_factory.mktemp("group")
    ranks = spawn_group(
        dp_ranks, WORLD, device="cpu",
        args=(trees, K, DI, [real[:, r * 8:(r + 1) * 8] for r in range(WORLD)],
              _shard_draws(key, WORLD, 8), data, _tree(global_draws), CFG,
              str(group_dir), cli_args[1]), timeout=300)
    return dict(ranks=ranks, sm=(sm_state, _np(sm_m)), gspmd=(g_state,
                _np(g_m)), single=single, solo=solo_out,
                group_dir=group_dir, cli_solo=cli_solo,
                cli_dirs=cli_dirs)


def _close(got, ref, rtol, atol, steps=1):
    """Leaf by leaf; the bias of a deconv before a BatchNorm has an exact
    gradient of 0, so both sides step it by rounding noise, each step by
    at most lr in either sign (tests/test_torch_gan_train.py): there the
    two agree within 2 lr a step."""
    got, ref = _np(got), _np(ref)
    for tree_g, tree_r in zip(got, ref):
        for name in tree_r:
            for leaf in tree_r[name]:
                a, b = tree_g[name][leaf], tree_r[name][leaf]
                if _exact_zero(name, leaf):
                    assert np.abs(a - b).max() <= 2 * steps * LR * 1.0001
                    continue
                np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                           err_msg=f"{name}/{leaf}")


def test_initialize_distributed_single_process_noop(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() == (0, 1)
    assert not torch.distributed.is_initialized()


def test_initialize_distributed_nccl_needs_cuda(monkeypatch):
    """No quiet switch to gloo: NCCL without a CUDA device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="gloo"):
        initialize_distributed(init_method="file:///nonexistent",
                               world_size=2, rank=0)


def test_spawn_group_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spawn_group(dp_ranks, 2)


def test_dp_step_matches_jax_shard_map(runs):
    sm_state, sm_m = runs["sm"]
    for r in runs["ranks"]:
        port = r["dp"]
        assert port["step"] == 1
        for k, v in sm_m.items():
            np.testing.assert_allclose(port["metrics"][k], float(v),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        for name, s in _np(sm_state.gen_stats).items():
            for leaf in ("mean", "var"):
                np.testing.assert_allclose(port["stats"][name][leaf],
                                           s[leaf], atol=1e-6)
        _assert_params_in_lr_units(port["gen"], sm_state.gen_params,
                                   sm_state.gen_opt_state[0].nu, 1)
        _assert_params_in_lr_units(port["disc"], sm_state.disc_params,
                                   sm_state.disc_opt_state[0].nu, 1)


def test_dp_step_keeps_ranks_equal(runs):
    """JAX's draws and then the port's own per-rank draws: every rank's
    weights and statistics stay equal bit for bit."""
    for r in runs["ranks"]:
        assert r["dp_equal"] and r["dp_own_equal"]


@pytest.mark.parametrize("ref", ["gspmd", "single"])
def test_global_batch_step_matches(runs, ref):
    if ref == "gspmd":
        g_state, g_m = runs["gspmd"]
        ref_m = {k: float(v) for k, v in g_m.items()}
        ref_p = (g_state.gen_params, g_state.disc_params, g_state.gen_stats)
    else:
        s = runs["single"]
        ref_m, ref_p = s["metrics"], (s["gen"], s["disc"], s["stats"])
    for r in runs["ranks"]:
        got = r["global"]
        assert got["step"] == 1 and r["global_equal"]
        for k, v in ref_m.items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=2e-4,
                                       atol=2e-4, err_msg=k)
        _close((got["gen"], got["disc"], got["stats"]), ref_p, 2e-3, 2e-4)


def test_trainer_under_a_group_is_the_global_batch_trainer(runs):
    solo = runs["solo"]
    for r in runs["ranks"]:
        got = r["trainer"]
        assert got["step"] == 2 and r["trainer_equal"]
        for k, v in solo["metrics"].items():
            if k != "train_steps_per_s":
                np.testing.assert_allclose(got["metrics"][k], v, rtol=2e-4,
                                           atol=2e-4, err_msg=k)
        _close((got["gen"], got["disc"], got["stats"]),
               (solo["gen"], solo["disc"], solo["stats"]), 2e-3, 2e-4,
               steps=2)
    # rank 0 alone wrote: one metrics line a step, one checkpoint
    rows = [json.loads(line) for line in
            open(runs["group_dir"] / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    assert sorted(p.name for p in (runs["group_dir"] / "checkpoints")
                  .iterdir()) == ["2.pt"]


def test_train_cli_under_a_group(runs):
    """train_torch.py in a group of two (torchrun's layout) trains the
    global batch: its metrics are the single process's, and rank 0 alone
    wrote the run."""
    for r in runs["ranks"]:
        for k, v in r["cli"].items():
            np.testing.assert_allclose(v, float(runs["cli_solo"][k]),
                                       rtol=2e-4, atol=2e-4, err_msg=k)
    solo, group = runs["cli_dirs"]
    assert len(open(group / "metrics.jsonl").readlines()) == \
        len(open(solo / "metrics.jsonl").readlines())
    assert sorted(p.name for p in (group / "samples").iterdir()) == \
        sorted(p.name for p in (solo / "samples").iterdir())
