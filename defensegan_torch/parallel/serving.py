"""Multi-GPU defended SERVING: the projection split over a mesh of devices
(port of the JAX package's parallel/serving.py).

The projection defense is data-parallel over the image batch: restarts
live inside each image's shard and the per-image argmin over R never
crosses shards (parallel/mesh.py::validate_projection_sharding). Serving
on several cards is therefore pure data parallelism with zero
collectives: each shard runs the single-device projection, kernels
included, on its own replica of the weights, and the results are
gathered on the first device.

`ShardedDefenseGAN` duck-types `DefenseGAN.reconstruct`, so every
defended consumer (eval/accuracy.py::batched_reconstruct, eval/detect.py,
defense/pipeline.py::DefendedPipeline) runs on several cards unchanged:

    pipe = DefendedPipeline(ShardedDefenseGAN(gan, make_mesh()), logits_fn)
    pipe.calibrate(x_clean).predict(x)

Restart draws: the call's base seed is one 63-bit draw from `gen` (the
first device's generator), or cfg.seed + 1 when gen is None; shard i draws
from `generator_for(fold_seed(base, i), mesh[i])`, the port's
`fold_in(key, axis_index)`. So the sharded call at batch B equals the
single-device calls on each shard with those generators, bit for bit on
the CPU and for a deterministic kernel on the card.

Attack graphs (back_prop=True) are out of scope by design, as in the JAX
package: build those on the single-device DefenseGAN.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from defensegan_torch.defense.project import ReconstructionResult
from defensegan_torch.parallel.mesh import (Mesh, make_mesh,
                                            validate_projection_sharding)
from defensegan_torch.utils.misc import fold_seed, generator_for


def base_seed(gen: Optional[torch.Generator], cfg) -> int:
    """The call's base seed: one 63-bit draw from `gen` (advancing it, as
    a call that samples z0 does), or cfg.seed + 1."""
    if gen is None:
        return cfg.seed + 1
    return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=gen,
                             device=gen.device).item())


class ShardedDefenseGAN:
    """Data-parallel serving wrapper over a trained DefenseGAN.

    Same `reconstruct` contract as DefenseGAN (minus back_prop). One
    replica of the GAN's weights per distinct mesh device, copied again
    whenever the GAN's weights are rebound (load, restore, train, a new
    encoder: DefenseGAN.weights_version).
    """

    def __init__(self, gan, mesh: Optional[Mesh] = None):
        self.gan = gan
        self.mesh = tuple(mesh) if mesh is not None else make_mesh()
        self.last_kernel: Optional[str] = None
        self._replicas: Dict[torch.device, object] = {}
        self._copied_version: Optional[int] = None

    # the surface consumers touch (DefendedPipeline, batched_reconstruct,
    # the resolver, classifier tags)
    @property
    def cfg(self):
        return self.gan.cfg

    @property
    def generator(self):
        return self.gan.generator

    @property
    def device(self) -> torch.device:
        """Where results are gathered: the first mesh device."""
        return self.mesh[0]

    def replica(self, device: torch.device):
        """The GAN's weights on `device` (copied when they changed)."""
        from defensegan_torch.gan.defense_gan import DefenseGAN
        gan = self.gan
        if self._copied_version != gan.weights_version:
            self._replicas.clear()
            self._copied_version = gan.weights_version
        if device not in self._replicas:
            rep = DefenseGAN(gan.cfg, device=device, seed=gan.seed)
            rep.generator.load_state_dict(gan.generator.state_dict())
            if gan.encoder is not None:
                rep._build_encoder().load_state_dict(
                    gan.encoder.state_dict())
            rep.step = gan.step
            self._replicas[device] = rep
        return self._replicas[device]

    def reconstruct(self, x, gen: Optional[torch.Generator] = None, *,
                    rec_rr: Optional[int] = None,
                    rec_iters: Optional[int] = None,
                    rec_lr: Optional[float] = None,
                    back_prop: bool = False,
                    kernel: Optional[str] = None,
                    init: Optional[str] = None,
                    z0: Optional[torch.Tensor] = None
                    ) -> ReconstructionResult:
        if back_prop:
            raise ValueError(
                "ShardedDefenseGAN is the serving path (no gradients "
                "through the shards); build attack graphs on the "
                "single-device DefenseGAN")
        from defensegan_torch.gan.defense_gan import _resolve
        cfg = self.gan.cfg
        rr = rec_rr if rec_rr is not None else cfg.rec_rr
        iters = rec_iters if rec_iters is not None else cfg.rec_iters
        lr = rec_lr if rec_lr is not None else cfg.rec_lr
        x = torch.as_tensor(x)
        validate_projection_sharding(self.mesh, x.shape[0], rr)
        n = len(self.mesh)
        b = x.shape[0] // n
        if z0 is not None and tuple(z0.shape[:2]) != (x.shape[0], rr):
            raise ValueError(f"z0 {tuple(z0.shape)} does not match the "
                             f"batch {x.shape[0]} x R {rr}")
        reps = [self.replica(d) for d in self.mesh]
        # resolve on each shard's replica (its device and per-shard rows),
        # then build every replica's reconstructor before any shard is
        # enqueued: the pack builders sync with the host, and a build
        # between two shards' launches would serialize them
        resolved = {_resolve(r, requested=kernel) for r in reps}
        if len(resolved) != 1:
            raise ValueError(f"the mesh's shards resolve to different "
                             f"paths {sorted(resolved)}: mixed device types")
        path, loop = resolved.pop()
        for rep in {id(r): r for r in reps}.values():
            rep._reconstructor_for(loop, rr, iters, lr, False)
        seed = base_seed(gen, cfg) if z0 is None else None
        outs = []
        for i, (dev, rep) in enumerate(zip(self.mesh, reps)):
            xi = x[i * b:(i + 1) * b].to(dev, non_blocking=True)
            zi = None if z0 is None else \
                z0[i * b:(i + 1) * b].to(dev, non_blocking=True)
            gi = None if z0 is not None else \
                generator_for(fold_seed(seed, i), dev)
            outs.append(rep.reconstruct(xi, gi, rec_rr=rr, rec_iters=iters,
                                        rec_lr=lr, kernel=path, init=init,
                                        z0=zi))
        self.last_kernel = path
        return ReconstructionResult(*(
            torch.cat([o[f].to(self.device, non_blocking=True)
                       for o in outs])
            for f in range(len(ReconstructionResult._fields))))
