"""Rank functions for the port's multi-process CPU tests
(tests/test_torch_distributed.py, test_torch_parallel_tp.py).

Spawned ranks import this module in a fresh interpreter: it imports torch
and the port only (never jax), and takes and returns numpy trees.
"""

import torch
import torch.distributed as dist

from defensegan_torch.ckpt.bridge import flax_tree, load_flax_tree
from defensegan_torch.configs import Config
from defensegan_torch.defense.project import reconstruct
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.gan.train import (Draws, init_gan_state,
                                        make_data_train_step)
from defensegan_torch.models import critic_for, generator_for
from defensegan_torch.parallel import (make_dp_train_step, make_mesh_2d,
                                       shard_params_tp, tp_generator_forward)


def _draws(d):
    return Draws(*(None if a is None else torch.from_numpy(a) for a in d))


def _state(trees, k):
    tg = load_flax_tree(generator_for("mnist", 4, arch="deep", latent_dim=k),
                        trees["gen_params"], trees["gen_stats"])
    tc = load_flax_tree(critic_for("mnist", 4), trees["disc_params"])
    return init_gan_state(tg, tc)


def _snapshot(state, metrics):
    gp, gs = flax_tree(state.generator)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                gen=gp, stats=gs, disc=flax_tree(state.critic)[0],
                step=state.step)


def _flat(state):
    return torch.cat([t.detach().reshape(-1) for t in
                      list(state.generator.state_dict().values())
                      + list(state.critic.state_dict().values())])


def _ranks_equal(state) -> bool:
    """Whether every rank holds bit-for-bit the same weights and
    statistics."""
    mine = _flat(state)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return all(torch.equal(parts[0], p) for p in parts[1:])


def dp_ranks(rank, world, device, trees, k, di, real, draws, data,
             global_draws, cfg_kw, out_dir, cli_args):
    """The data-parallel checks of one rank: JAX's explicit shard_map step
    (make_dp_train_step on the rank's batch and draws), the global-batch
    data step (on JAX's global draws), DefenseGAN.train under the group
    and the training CLI under it (cli_args)."""
    torch.set_num_threads(1)
    group = dist.group.WORLD
    out = {}
    # 1. the explicit DP step, given this rank's JAX draws, then one step
    #    on the port's own per-rank draws (seed folded by rank)
    state = _state(trees, k)
    step = make_dp_train_step(state, group=group, latent_dim=k,
                              disc_iters=di)
    m = step(torch.from_numpy(real[rank]), 0, _draws(draws[rank]))
    out["dp"] = _snapshot(state, m)
    out["dp_equal"] = _ranks_equal(state)
    step(torch.from_numpy(real[rank]), 7)
    out["dp_own_equal"] = _ranks_equal(state)
    # 2. the global-batch data step on JAX's global draws
    state = _state(trees, k)
    b_global = global_draws[2].shape[0]
    step = make_data_train_step(state, latent_dim=k, batch_size=b_global,
                                disc_iters=di, group=group)
    m = step(torch.from_numpy(data), None, _draws(global_draws))
    out["global"] = _snapshot(state, m)
    out["global_equal"] = _ranks_equal(state)
    # 3. DefenseGAN.train under the group (rank 0 writes)
    gan = DefenseGAN(Config(output_dir=out_dir, **cfg_kw), device="cpu")
    metrics = gan.train(data, train_iters=2, log_every=1, quiet=True)
    metrics.pop("train_steps_per_s", None)
    gp, gs = flax_tree(gan.generator)
    out["trainer"] = dict(metrics=metrics, gen=gp, stats=gs,
                          disc=flax_tree(gan.critic)[0], step=gan.step)
    out["trainer_equal"] = _ranks_equal(gan.state)
    # 4. the training CLI in the group
    from defensegan_torch.cli.train import main
    cli = main(cli_args)
    out["cli"] = {k: float(v) for k, v in cli.items()
                  if k != "train_steps_per_s"}
    return out


def tp_ranks(rank, world, device, trees, k, n_data, z, x, z0, rec_iters):
    """The channel-split generator on a (data, model) mesh: its forward on
    the rank's data shard of z, and the projection of the rank's shard of
    x from its shard of z0 through it."""
    torch.set_num_threads(1)
    mesh = make_mesh_2d(n_data, world // n_data)
    group = mesh.get_group("model")
    d_rank, m_rank = mesh.get_coordinate()
    n_model = world // n_data
    gen = load_flax_tree(generator_for("mnist", trees["dim"], latent_dim=k),
                         trees["params"], trees["stats"]).requires_grad_(False)
    shards = shard_params_tp(gen, n_model, m_rank)

    def apply(zz):
        return tp_generator_forward(gen, shards, zz, group)

    def part(a):
        b = a.shape[0] // n_data
        return torch.from_numpy(a[d_rank * b:(d_rank + 1) * b])
    with torch.no_grad():
        out = apply(part(z)).numpy()
    res = reconstruct(apply, part(x), part(z0), rec_iters=rec_iters)
    return dict(data_rank=d_rank, model_rank=m_rank, forward=out,
                x_hat=res.x_hat.numpy(), loss=res.loss.numpy(),
                all_losses=res.all_losses.numpy(),
                split={n: d for n, (_, d) in shards.items()},
                local_shapes={n: tuple(t.shape)
                              for n, (t, _) in shards.items()})
