#!/usr/bin/env python3
"""Multi-device dry run of the PyTorch/CUDA port.

    python multichip_torch.py [N]              # N NCCL ranks, one a GPU
    python multichip_torch.py 4 --device cpu   # 4 gloo ranks on the CPU

`dryrun_multichip(n, device=None)` starts n processes joined in one
process group (defensegan_torch/parallel/distributed.py::spawn_group; a
file:// rendezvous, no network) and runs, on a small seeded model (deep
MNIST generator at GEN_DIM 8, LATENT_DIM 32, DISC_ITERS 2, float32):

  1. the global-batch data-parallel train step (batch 2n split over the
     ranks, BatchNorm on the global batch) against the single-process
     step on the same global batch and draws (tests/test_parallel.py's
     bounds: metrics rtol 2e-4 / atol 2e-4, parameters rtol 2e-3 / atol
     2e-4, a deconv bias before a BatchNorm within 2 lr);
  2. the explicit DP step (make_dp_train_step, per-rank draws): finite
     metrics, every rank's weights equal bit for bit;
  3. a sharded projection at batch 3n, R 3 (each rank projects its 3
     images) against the full batch's rows (rtol 1e-4 / atol 1e-5, equal
     argmins), and a batch of 3n + 1 rejected when n > 1;
  4. the channel-split generator on a (n/2, 2) data x model mesh against
     the replicated forward (rtol 5e-5 / atol 5e-6), when n is even;
  5. on rank 0, ShardedDefenseGAN over n shards (the n GPUs, or n CPU
     shards) against per-shard single-device runs with the folded seeds,
     random and encoder init (rtol 1e-5 / atol 1e-6), and
  6. DefendedPipeline(detector="combined", detect_passes=2, vote=True)
     calibrated and predicting through it.

This folds in the JAX package's two-process rehearsal: every check runs
in separate processes over real collectives. It prints one line of
results; a failed check raises (exit code 1).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

LR = 1e-4


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _close(a, b, rtol: float, atol: float) -> bool:
    import torch
    return bool(torch.allclose(a.float(), b.float(), rtol=rtol, atol=atol))


def _params_close(got, ref, steps: int = 1) -> float:
    """Generator and critic parameters, leaf by leaf: rtol 2e-3 / atol 2e-4;
    the bias of a deconv before a BatchNorm (exact gradient 0, stepped by
    rounding noise) within 2 lr a step. Returns the largest |difference|."""
    worst = 0.0
    for (name, a), (_, b) in zip(got, ref):
        worst = max(worst, _max_err(a, b))
        if name.startswith("deconv_") and not name.startswith(
                "deconv_out") and name.endswith("bias"):
            _require(_max_err(a, b) <= 2 * steps * LR * 1.0001,
                     f"{name} moved {_max_err(a, b)}")
        else:
            _require(_close(a, b, 2e-3, 2e-4), f"{name} differs by "
                     f"{_max_err(a, b)}")
    return worst


def _named(state):
    return list(state.generator.state_dict().items()) + \
        [("critic." + k, v) for k, v in state.critic.state_dict().items()]


def _ranks_equal(tensors) -> bool:
    import torch
    import torch.distributed as dist
    mine = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return all(torch.equal(parts[0], p) for p in parts[1:])


def _checks(rank: int, world: int, device, n: int) -> dict:
    """Every rank's part of the dry run (module docstring)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from defensegan_torch.configs import Config
    from defensegan_torch.defense.encoder_init import train_encoder
    from defensegan_torch.defense.pipeline import DefendedPipeline
    from defensegan_torch.defense.project import reconstruct, sample_z0
    from defensegan_torch.gan import DefenseGAN
    from defensegan_torch.gan.train import (draw_step, init_gan_state,
                                            make_data_train_step)
    from defensegan_torch.models import critic_for, generator_for
    from defensegan_torch.parallel import (ShardedDefenseGAN,
                                           make_dp_train_step, make_mesh,
                                           make_mesh_2d, shard_params_tp,
                                           tp_generator_forward,
                                           validate_projection_sharding)
    from defensegan_torch.parallel.serving import base_seed
    from defensegan_torch.utils.misc import fold_seed, generator_for as gfor

    if device.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    group = dist.group.WORLD
    cfg = Config(type="mnist", gen_dim=8, disc_dim=8, latent_dim=32,
                 disc_iters=2, rec_rr=3, rec_iters=4,
                 compute_dtype="float32")
    k, di = cfg.latent_dim, cfg.disc_iters
    out = {}

    def new_state():
        g = generator_for(cfg.type, cfg.gen_dim, latent_dim=k,
                          gen=torch.Generator().manual_seed(0))
        c = critic_for(cfg.type, cfg.disc_dim,
                       gen=torch.Generator().manual_seed(1))
        return init_gan_state(g.to(device), c.to(device))

    # 1. the global-batch step against the single-process step
    data = torch.from_numpy(np.random.RandomState(1).rand(
        32, 28, 28, 1).astype(np.float32)).to(device)
    b_global = 2 * n
    draws = draw_step(gfor(2, device), n_data=32, batch=b_global,
                      disc_iters=di, latent_dim=k, device=device)
    state = new_state()
    single = copy.deepcopy(state)
    step_kw = dict(latent_dim=k, batch_size=b_global, disc_iters=di)
    m = make_data_train_step(state, group=group, **step_kw)(data, None,
                                                            draws)
    m1 = make_data_train_step(single, **step_kw)(data, None, draws)
    for key in m1:
        _require(_close(m[key], m1[key], 2e-4, 2e-4),
                 f"global-batch {key} {float(m[key])} != {float(m1[key])}")
    out["global_step_param_err"] = _params_close(_named(state),
                                                 _named(single))
    out["global_step_bit_equal"] = all(
        torch.equal(a, b) for (_, a), (_, b) in zip(_named(state),
                                                    _named(single)))
    _require(_ranks_equal([t for _, t in _named(state)]),
             "ranks differ after the global-batch step")
    out["d_loss"] = float(m["d_loss"])

    # 2. the explicit DP step on per-rank batches and draws
    real = torch.from_numpy(np.random.RandomState(3).rand(
        di, b_global, 28, 28, 1).astype(np.float32)).to(device)
    dp_state = new_state()
    sm = make_dp_train_step(dp_state, group=group, latent_dim=k,
                            disc_iters=di)(real[:, 2 * rank:2 * rank + 2], 5)
    _require(all(bool(torch.isfinite(v)) for v in sm.values()),
             f"DP step metrics {sm}")
    _require(_ranks_equal([t for _, t in _named(dp_state)]),
             "ranks differ after the explicit DP step")
    out["dp_d_loss"] = float(sm["d_loss"])

    # 3. a sharded projection: batch 3n, R 3, each rank its 3 images
    gen = state.generator.requires_grad_(False)
    mesh_n = make_mesh(devices=[device] * n)
    proj_batch, rr = 3 * n, 3
    validate_projection_sharding(mesh_n, proj_batch, rr)
    if n > 1:
        try:
            validate_projection_sharding(mesh_n, proj_batch + 1, rr)
        except ValueError:
            pass
        else:
            raise AssertionError("dryrun_multichip: a batch of 3n + 1 was "
                                 "accepted")
    x = torch.rand((proj_batch, 28, 28, 1), generator=gfor(3, "cpu"))
    z0 = sample_z0(gfor(4, "cpu"), proj_batch, rr, k)
    full = reconstruct(gen, x.to(device), z0.to(device), rec_iters=4)
    mine = reconstruct(gen, x[3 * rank:3 * rank + 3].to(device),
                       z0[3 * rank:3 * rank + 3].to(device), rec_iters=4)
    rows = slice(3 * rank, 3 * rank + 3)
    _require(_close(mine.x_hat, full.x_hat[rows], 1e-4, 1e-5)
             and torch.equal(mine.all_losses.argmin(1),
                             full.all_losses[rows].argmin(1)),
             "the sharded projection differs from the full batch")
    out["projection_err"] = _max_err(mine.x_hat, full.x_hat[rows])

    # 4. the channel-split generator on a (n / 2, 2) mesh
    if n >= 2 and n % 2 == 0:
        mesh2 = make_mesh_2d(n // 2, 2)
        d_rank, m_rank = mesh2.get_coordinate()
        zt = torch.randn((n, k), generator=gfor(11, "cpu")).to(device)
        shards = shard_params_tp(gen, 2, m_rank)
        with torch.no_grad():
            tp = tp_generator_forward(gen, shards, zt[2 * d_rank:
                                                      2 * d_rank + 2],
                                      mesh2.get_group("model"))
            ref = gen(zt)[2 * d_rank:2 * d_rank + 2]
        _require(_close(tp, ref, 5e-5, 5e-6), "the channel-split generator "
                 f"differs from the replicated one by {_max_err(tp, ref)}")
        out["tp_err"] = _max_err(tp, ref)
    else:
        out["tp_err"] = None        # needs an even number of ranks

    if rank != 0:
        return out
    # 5. ShardedDefenseGAN against per-shard single-device runs
    lgan = DefenseGAN(cfg, device=device)
    lgan.generator.load_state_dict(gen.state_dict())
    lgan.step = 1
    lgan.weights_changed()
    if device.type == "cuda":
        mesh = make_mesh(n)
    else:
        mesh = make_mesh(devices=["cpu"] * n)
    sgan = ShardedDefenseGAN(lgan, mesh)
    x_serve = torch.rand((proj_batch, 28, 28, 1), generator=gfor(5, "cpu"))
    errs = {}
    for init in ("random", "encoder"):
        if init == "encoder":
            enc, _ = train_encoder(lgan._build_encoder(),
                                   lgan.gen_apply_tanh, x_serve.numpy(),
                                   gfor(12, device), iters=8, batch_size=8,
                                   quiet=True)
            lgan.encoder = enc
            lgan.weights_changed()
        gen_s = gfor(6, device)
        serve = sgan.reconstruct(x_serve, gen_s, kernel="xla", init=init)
        seed = base_seed(gfor(6, device), cfg)
        worst = 0.0
        for i, dev in enumerate(mesh):
            lo = 3 * i
            r = lgan.reconstruct(x_serve[lo:lo + 3],
                                 gfor(fold_seed(seed, i), device),
                                 kernel="xla", init=init)
            for f in ("x_hat", "loss"):
                a, b = getattr(serve, f)[lo:lo + 3], getattr(r, f)
                worst = max(worst, _max_err(a, b.to(a.device)))
                _require(_close(a, b.to(a.device), 1e-5, 1e-6),
                         f"sharded {init} {f} drifted on shard {i}")
        errs[init] = worst
    out["sharded_err"] = errs

    # 6. the defended pipeline over the sharded GAN
    def logits_fn(xb):
        mean = xb.mean((1, 2, 3))
        return torch.stack([1.0 - mean, mean], -1)

    pipe = DefendedPipeline(sgan, logits_fn, fpr=0.25, detector="combined",
                            detect_passes=2, vote=True)
    pipe.calibrate(torch.rand((proj_batch, 28, 28, 1),
                              generator=gfor(7, "cpu")), gfor(8, device),
                   batch_size=proj_batch)
    res = pipe.predict(torch.rand((proj_batch, 28, 28, 1),
                                  generator=gfor(9, "cpu")), gfor(10, device),
                       batch_size=proj_batch)
    _require(res.pred.shape == (proj_batch,) and res.rec_err.shape ==
             (proj_batch,) and res.margin.shape == (proj_batch,)
             and bool(np.isfinite(res.rec_err).all()),
             "the pipeline over the sharded GAN")
    out["flagged"] = int(res.flagged.sum())
    out["pipeline_path"] = sgan.last_kernel
    return out


def dryrun_multichip(n_devices: int, device: str = None) -> dict:
    """Run the dry run on n_devices ranks: NCCL, one GPU a rank (device
    None or "cuda"), or gloo on the CPU (device="cpu"). Returns rank 0's
    results after printing them on one line; raises if any check fails."""
    from defensegan_torch.parallel import spawn_group
    device = device or "cuda"
    ranks = spawn_group(_checks, n_devices, device=device,
                        args=(n_devices,), timeout=900)
    line = dict(ranks[0], n=n_devices, device=device,
                backend="gloo" if device == "cpu" else "nccl", ok=True)
    print("dryrun_multichip: " + json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n", type=int, nargs="?", default=None,
                    help="ranks (default: every GPU; 4 with --device cpu)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    n = args.n
    if n is None:
        import torch
        if args.device == "cpu":
            n = 4
        elif not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to run the "
                             "ranks on the CPU")
        else:
            n = torch.cuda.device_count()
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
