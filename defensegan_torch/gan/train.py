"""WGAN-GP training step (port of the JAX package's gan/train.py).

Reference parity: models/gan.py::DefenseGANBase.train of
kabkabm/defensegan: n_critic critic updates per generator update, Adam,
the gradient penalty.

One step = `disc_iters` critic updates, each on its own minibatch and with
its own z and eps, then one generator update:
  - the critic's fake comes from the generator in training mode (BatchNorm
    on the batch statistics) under no_grad, and leaves the running
    statistics alone (JAX discards them: gen_fake(..., mutable=False));
  - the generator update runs the same training-mode forward, folds the
    batch statistics into the running averages (flax momentum 0.99,
    biased variance: models/layers.py::BatchNorm) and scores the fake with
    the critic's weights after this step's critic updates.
Metrics are those of the last critic update plus g_loss, as device tensors
(reading one waits for the device: the trainer reads them only at its log,
sample and save boundaries).

Random draws come from a torch.Generator on the data's device; the JAX
package's streams differ, so every draw is also injectable (`Draws`): the
CPU tests pass JAX's draws in.

Data parallel (a torch.distributed process group, the JAX step's
`axis_name`): every optimizer update averages its gradients over the
group with one all-reduce of a flat buffer (disc_iters + 1 a step), and
the metrics are averaged. Two layouts:
  - per-rank batches with local BatchNorm statistics, the running
    statistics averaged after the generator update (JAX's shard_map
    step; parallel/distributed.py::make_dp_train_step);
  - the global batch split over the ranks (`global_batch=True`, JAX's
    GSPMD step): BatchNorm's moments are the global batch's
    (models/layers.py), so the step equals the single-process step on the
    global batch; make_data_train_step(group=...) draws the global batch
    on every rank and takes the rank's slice.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from defensegan_torch.gan.losses import critic_loss_fn, generator_loss_fn
from defensegan_torch.models.generator import from_image_space

Metrics = Dict[str, torch.Tensor]


class Draws(NamedTuple):
    """One step's random numbers: z_critic [disc_iters, B, k], eps
    [disc_iters, B], z_gen [B, k], and for the data step the minibatch
    indices idx [disc_iters, B]."""
    z_critic: torch.Tensor
    eps: torch.Tensor
    z_gen: torch.Tensor
    idx: Optional[torch.Tensor] = None


def draw_step(gen: Optional[torch.Generator], *, n_data: int, batch: int,
              disc_iters: int, latent_dim: int, device) -> Draws:
    """One data step's draws from `gen`, in the order the step consumes
    them: the minibatch indices, each critic iteration's z and eps, then
    the generator's z."""
    idx = torch.randint(0, n_data, (disc_iters, batch), generator=gen,
                        device=device)
    zs, es = [], []
    for _ in range(disc_iters):
        zs.append(torch.randn((batch, latent_dim), generator=gen,
                              device=device))
        es.append(torch.rand((batch,), generator=gen, device=device))
    z_gen = torch.randn((batch, latent_dim), generator=gen, device=device)
    return Draws(torch.stack(zs), torch.stack(es), z_gen, idx)


def rank_slice(draws: Draws, group) -> Draws:
    """The calling rank's equal share of a global step's draws (the batch
    axis split in rank order)."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    b = draws.z_gen.shape[0]
    if b % world:
        raise ValueError(f"batch {b} is not divisible by the {world} ranks")
    lo, hi = rank * b // world, (rank + 1) * b // world
    return Draws(draws.z_critic[:, lo:hi], draws.eps[:, lo:hi],
                 draws.z_gen[lo:hi],
                 None if draws.idx is None else draws.idx[:, lo:hi])


def all_reduce_mean(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The group's mean of each tensor, by one all-reduce of a flat buffer
    (one float dtype)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


class GANState:
    """The training state: both modules (parameters, and the generator's
    BatchNorm running statistics), both Adam states and the step count."""

    def __init__(self, generator: nn.Module, critic: nn.Module,
                 gen_opt: torch.optim.Optimizer,
                 disc_opt: torch.optim.Optimizer, step: int = 0):
        self.generator, self.critic = generator, critic
        self.gen_opt, self.disc_opt = gen_opt, disc_opt
        self.step = step

    def state_dict(self) -> dict:
        return {"generator": self.generator.state_dict(),
                "critic": self.critic.state_dict(),
                "gen_opt": self.gen_opt.state_dict(),
                "disc_opt": self.disc_opt.state_dict(),
                "step": int(self.step)}

    def load_state_dict(self, sd: dict) -> None:
        self.generator.load_state_dict(sd["generator"])
        self.critic.load_state_dict(sd["critic"])
        self.gen_opt.load_state_dict(sd["gen_opt"])
        self.disc_opt.load_state_dict(sd["disc_opt"])
        self.step = int(sd["step"])


def build_optimizers(generator: nn.Module, critic: nn.Module,
                     gen_lr: float = 1e-4, disc_lr: float = 1e-4,
                     beta1: float = 0.5, beta2: float = 0.9
                     ) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    """The canonical WGAN-GP Adam pair (arXiv:1704.00028). torch's Adam is
    optax.adam's update: bias-corrected moments, eps 1e-8 added outside
    the square root, no weight decay."""
    def adam(module, lr):
        return torch.optim.Adam(module.parameters(), lr=lr,
                                betas=(beta1, beta2), eps=1e-8)
    return adam(generator, gen_lr), adam(critic, disc_lr)


def init_gan_state(generator: nn.Module, critic: nn.Module, *,
                   gen_lr: float = 1e-4, disc_lr: float = 1e-4,
                   beta1: float = 0.5, beta2: float = 0.9) -> GANState:
    """A fresh state on the modules' current weights: both unfrozen, both
    Adam states empty, step 0."""
    generator.requires_grad_(True)
    critic.requires_grad_(True)
    gen_opt, disc_opt = build_optimizers(generator, critic, gen_lr, disc_lr,
                                         beta1, beta2)
    return GANState(generator, critic, gen_opt, disc_opt)


def make_train_step(state: GANState, *, latent_dim: int,
                    disc_iters: int = 5, gp_lambda: float = 10.0,
                    group=None, global_batch: bool = False
                    ) -> Callable[..., Metrics]:
    """train_step(real [disc_iters, B, H, W, C] in [0, 1], gen, draws=None)
    -> metrics; advances `state` in place. Draws come from the
    torch.Generator `gen` on real's device unless `draws` is given.

    group: data parallel over a process group (module docstring): `real`
    and the draws are the rank's share; global_batch=True takes BatchNorm's
    moments over the group's global batch, else each rank normalizes its
    own and the running statistics are averaged after the update. With
    group=None the step is the single-process one."""
    generator, critic = state.generator, state.critic
    gen_params = [p for p in generator.parameters()]
    bn_group = group if global_batch else None

    def sync_grads(params):
        if group is not None:
            live = [p for p in params if p.grad is not None]
            for p, g in zip(live, all_reduce_mean([p.grad for p in live],
                                                  group)):
                p.grad.copy_(g)

    def train_step(real_images: torch.Tensor,
                   gen: Optional[torch.Generator] = None,
                   draws: Optional[Draws] = None) -> Metrics:
        real = from_image_space(real_images)
        batch, dev = real.shape[1], real.device

        def normal(shape):
            return torch.randn(shape, generator=gen, device=dev)

        for i in range(disc_iters):
            if draws is None:
                z = normal((batch, latent_dim))
                eps = torch.rand((batch,), generator=gen, device=dev)
            else:
                z, eps = draws.z_critic[i], draws.eps[i]
            with torch.no_grad():
                fake = generator(z, train=True, group=bn_group)
            d_loss, aux = critic_loss_fn(critic, real[i], fake, eps,
                                         gp_lambda=gp_lambda)
            state.disc_opt.zero_grad(set_to_none=True)
            d_loss.backward()
            sync_grads(critic.parameters())
            state.disc_opt.step()

        z = normal((batch, latent_dim)) if draws is None else draws.z_gen
        fake = generator(z, train=True, update_stats=True, group=bn_group)
        g_loss = generator_loss_fn(critic, fake)
        grads = torch.autograd.grad(g_loss, gen_params)
        for p, g in zip(gen_params, grads):
            p.grad = g
        sync_grads(gen_params)
        state.gen_opt.step()
        if group is not None and not global_batch:
            # keep the BatchNorm running averages equal across ranks
            bufs = list(generator.buffers())
            with torch.no_grad():
                for t, m in zip(bufs, all_reduce_mean(bufs, group)):
                    t.copy_(m)
        state.step += 1
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics.update(d_loss=d_loss.detach(), g_loss=g_loss.detach())
        if group is not None:
            metrics = dict(zip(metrics, all_reduce_mean(
                [v.float() for v in metrics.values()], group)))
        return metrics

    return train_step


def make_data_train_step(state: GANState, *, latent_dim: int,
                         batch_size: int, disc_iters: int = 5,
                         gp_lambda: float = 10.0, group=None
                         ) -> Callable[..., Metrics]:
    """train_step(data, gen, draws=None) -> metrics over a dataset resident
    on the device: data [N, H, W, C] float32 in [0, 1] or uint8 (divided by
    255 per minibatch, a quarter of float32's memory). Each step draws its
    disc_iters x batch_size indices with replacement (JAX's semantics: no
    epoch cursor to carry or checkpoint).

    group: the global-batch data-parallel step. Every rank holds the whole
    dataset and the same `gen`, draws the global step's draws (or takes
    the global `draws`) and trains on its slice of batch_size, so the step
    equals the single-process one on the global batch."""
    inner = make_train_step(state, latent_dim=latent_dim,
                            disc_iters=disc_iters, gp_lambda=gp_lambda,
                            group=group, global_batch=True)

    def train_step(data: torch.Tensor, gen: Optional[torch.Generator] = None,
                   draws: Optional[Draws] = None) -> Metrics:
        if draws is None:
            draws = draw_step(gen, n_data=data.shape[0], batch=batch_size,
                              disc_iters=disc_iters, latent_dim=latent_dim,
                              device=data.device)
        if group is not None:
            draws = rank_slice(draws, group)
        real = data[draws.idx]
        if real.dtype == torch.uint8:
            real = real.to(torch.float32) / 255.0
        return inner(real, gen, draws)

    return train_step
