"""Multi-process bootstrap and the explicit-collective data-parallel train
step (port of the JAX package's parallel/distributed.py).

  - `initialize_distributed()` joins a torch.distributed process group
    from torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT) or from explicit arguments; a no-op in one process. NCCL
    on the card, gloo only when the caller asks for the CPU.
  - `make_dp_train_step()` is the counterpart of JAX's
    make_shard_map_train_step: each rank trains on its own batch with its
    own draws (the seed folded by rank), gradients, BatchNorm running
    statistics and metrics averaged over the group (gan/train.py).
  - `spawn_group()` runs a function on every rank of a new group of local
    processes (file:// rendezvous, no network) and returns each rank's
    result: the multi-chip dry run (multichip_torch.py) and the tests run
    on it.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from defensegan_torch.gan.train import GANState, make_train_step
from defensegan_torch.utils.misc import fold_seed, generator_for


def initialize_distributed(backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> Tuple[int, int]:
    """Join the process group; returns (rank, world_size).

    Arguments default to torchrun's environment; with a world of 1 (or
    none given) and no group yet, nothing happens and (0, 1) comes back.
    backend defaults to "nccl", which needs CUDA: pass backend="gloo" to
    run the group on the CPU. Under NCCL the rank's GPU (LOCAL_RANK, else
    rank modulo the device count) becomes the current device."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size <= 1 and init_method is None:
        return 0, 1
    backend = backend or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the NCCL backend; pass "
                               "backend='gloo' to run the group on the CPU")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return dist.get_rank(), dist.get_world_size()


def make_dp_train_step(state: GANState, *, group, latent_dim: int,
                       disc_iters: int = 5, gp_lambda: float = 10.0):
    """Explicit-collective DP train step over `group`.

    fn(real [disc_iters, B_local, H, W, C] in [0, 1], seed, draws=None)
    -> metrics, advancing `state` (replicated: equal on every rank after
    each step). Draws come from generator_for(fold_seed(seed, rank)) on
    real's device unless the rank's `draws` are given."""
    step = make_train_step(state, latent_dim=latent_dim,
                           disc_iters=disc_iters, gp_lambda=gp_lambda,
                           group=group)
    rank = dist.get_rank(group)

    def train_step(real: torch.Tensor, seed: int, draws=None):
        gen = None if draws is not None else \
            generator_for(fold_seed(seed, rank), real.device)
        return step(real, gen, draws)

    return train_step


# ------------------------------------------------------------- local groups
def _rank_main(rank: int, world: int, backend: str, init: str,
               fn: Callable, args: tuple, results) -> None:
    try:
        initialize_distributed(backend, init, world, rank)
        device = torch.device("cuda", torch.cuda.current_device()) \
            if backend == "nccl" else torch.device("cpu")
        out = fn(rank, world, device, *args)
        dist.barrier()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_group(fn: Callable, world_size: int, *, device: str = "cuda",
                args: Sequence[Any] = (), timeout: float = 600.0
                ) -> List[Any]:
    """Run fn(rank, world_size, device, *args) on `world_size` new local
    processes joined in one group: NCCL with one GPU a rank on the card
    (world_size <= device count), gloo with device="cpu". Returns the
    ranks' results in rank order (they must pickle: numpy and Python
    values). fn must be importable (a module-level function of a module
    that a fresh interpreter can import). A rank that raises, or a group
    that outlives `timeout` seconds, ends every process and raises."""
    if device == "cpu":
        backend = "gloo"
    elif device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the group on the CPU")
        if world_size > torch.cuda.device_count():
            raise ValueError(f"{world_size} NCCL ranks need as many GPUs, "
                             f"have {torch.cuda.device_count()}")
        backend = "nccl"
    else:
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="dgan_group_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, backend, init, fn,
                                   tuple(args), results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world_size:
                try:
                    rank, ok, out = results.get(
                        timeout=max(deadline - time.monotonic(), 0.1))
                except queue.Empty:
                    raise RuntimeError(f"the {world_size}-rank group did not "
                                       f"finish in {timeout:.0f} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                got[rank] = out
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"group processes exited with {bad}")
    return [got[r] for r in range(world_size)]
