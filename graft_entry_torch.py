#!/usr/bin/env python3
"""The PyTorch/CUDA port's entry points (the JAX package's
__graft_entry__.py): a single-device check of the flagship workload and
the multi-device dry run.

    python3 graft_entry_torch.py [N]              # N NCCL ranks, one a GPU
    python3 graft_entry_torch.py 4 --device cpu   # 4 gloo ranks on the CPU

entry(device=None)     -> (fn, example_args): fn(params, stats, x, z0) ->
                          purified images, the generator-manifold
                          projection of Config(type="mnist") (the deep
                          generator at dim 64, latent 128) at its own R, L,
                          lr and momentum, on batch 4.
project(params, stats, x, z0) -> fn's whole ReconstructionResult.
params_from_flax(...)  -> the (params, stats) of entry's fn from flax
                          trees, as the JAX entry's init returns them.
dryrun_multichip(n, device=None): multichip_torch.dryrun_multichip, the
                          same function (its docstring lists the checks).

Everything runs on the card unless the caller passes device="cpu"; with
no card and no such request, entry raises.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from multichip_torch import dryrun_multichip  # noqa: E402,F401
from multichip_torch import main  # noqa: E402

BATCH = 4
SEEDS = dict(params=0, x=1, z0=2)     # the JAX entry's keys 0, 1 and 2


def _device(device):
    import torch

    from defensegan_torch.gan.defense_gan import default_device
    return default_device() if device is None else torch.device(device)


def _generator(device="cpu"):
    """The entry's config and its generator: on the CPU seeded 0, or on
    "meta" (the structure alone, for functional_call)."""
    import torch

    from defensegan_torch.configs import Config
    from defensegan_torch.models import generator_for

    cfg = Config(type="mnist")
    seed = torch.Generator().manual_seed(SEEDS["params"]) \
        if device == "cpu" else None
    with torch.device(device):
        gen = generator_for(cfg.type, cfg.gen_dim, arch=cfg.gen_arch,
                            latent_dim=cfg.latent_dim, gen=seed)
    return cfg, gen


def _dicts(gen, dev):
    """The generator's parameters and BatchNorm buffers as two dicts of
    tensors on `dev` (flax's params and batch_stats)."""
    params = {n: p.detach().to(dev) for n, p in gen.named_parameters()}
    stats = {n: b.detach().to(dev) for n, b in gen.named_buffers()}
    return params, stats


def project(params, stats, x, z0):
    """entry's fn with its whole result: the ReconstructionResult (x_hat,
    z_star, loss, all_losses) of defense.project.reconstruct at the
    config's L 200, lr 10 and momentum 0.7, the generator applied through
    torch.func.functional_call with the two dicts in inference mode
    (BatchNorm on the running statistics, as the JAX entry's
    train=False)."""
    from torch.func import functional_call

    from defensegan_torch.defense.project import reconstruct

    cfg, gen = _generator("meta")

    def gen_apply(z):
        return functional_call(gen, (params, stats), (z,), strict=True)
    return reconstruct(gen_apply, x, z0, rec_iters=cfg.rec_iters,
                       rec_lr=cfg.rec_lr, momentum=cfg.rec_momentum)


def entry(device=None):
    """The flagship forward step: (fn, (params, stats, x, z0)).

    fn(params, stats, x, z0) projects x [4, 28, 28, 1] in [0, 1] from z0
    [4, R 10, 128] (project) and returns x_hat [4, 28, 28, 1] float32 in
    [0, 1].

    The weights are the port's seeded init (a torch.Generator seeded 0):
    lecun-normal as a plain normal, where flax draws a truncated normal, so
    they are not the JAX entry's weights; params_from_flax carries those
    across. x is uniform in [0, 1) from a generator seeded 1 and z0 is
    sample_z0's N(0, I) from one seeded 2, both drawn on the CPU, so every
    device gets the same example.
    """
    import torch

    from defensegan_torch.defense.project import sample_z0
    from defensegan_torch.utils.misc import generator_for as seeded

    dev = _device(device)
    cfg, gen = _generator()
    params, stats = _dicts(gen, dev)

    def fn(params, stats, x, z0):
        return project(params, stats, x, z0).x_hat

    x = torch.rand((BATCH,) + cfg.image_shape,
                   generator=seeded(SEEDS["x"], "cpu")).to(dev)
    z0 = sample_z0(seeded(SEEDS["z0"], "cpu"), BATCH, cfg.rec_rr,
                   cfg.latent_dim, device=dev)
    return fn, (params, stats, x, z0)


def params_from_flax(params, batch_stats, device=None):
    """(params, stats) for entry's fn from the JAX entry's flax trees
    (numpy arrays in flax's layout), through ckpt/bridge.py::load_flax_tree:
    a missing or extra layer raises."""
    from defensegan_torch.ckpt.bridge import load_flax_tree

    dev = _device(device)
    _, gen = _generator()
    load_flax_tree(gen, params, batch_stats)
    return _dicts(gen, dev)


if __name__ == "__main__":
    sys.exit(main())
