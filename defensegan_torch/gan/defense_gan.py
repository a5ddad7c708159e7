"""DefenseGAN: the user-facing model: WGAN-GP and encoder training,
inference, and the differentiable projection of the white-box attacks
(port of the JAX package's gan/defense_gan.py).

    gan = DefenseGAN(load_config("output/gans/mnist_fast")).load()
    res = gan.reconstruct(x)          # x [B, 28, 28, 1] in [0, 1] or uint8

    gan = DefenseGAN(cfg)             # a new run
    gan.train(x_train)                # checkpoints, export, samples, metrics

Entry points run on CUDA unless the caller passes another `device`;
without a CUDA device and without `device`, the constructor raises rather
than falling back to the CPU. Weights come from the run's numpy export
(`<output_dir>/export/<step>.npz`: written by
scripts/export_torch_weights.py for a JAX run, by `save` for a run the
port trained). The full training state (both modules, both Adam states,
the step and the draw generator) is the torch checkpoint
`<output_dir>/checkpoints/<step>.pt`, which `restore` resumes from.
Serving keeps the generator frozen; training unfreezes it and the critic
for its duration.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from defensegan_torch.ckpt.bridge import (export_path, load_flax_tree,
                                          read_export, write_export)
from defensegan_torch.ckpt.checkpoint import (latest_step,
                                              restore_checkpoint,
                                              save_checkpoint)
from defensegan_torch.configs import Config, save_config
from defensegan_torch.defense.project import (ReconstructionResult,
                                              reconstruct, sample_z0)
from defensegan_torch.kernels import (build, dense_kernel_available,
                                      make_dense_int8_reconstructor,
                                      make_dense_reconstructor,
                                      make_s2d_reconstructor,
                                      make_v4_reconstructor,
                                      s2d_kernel_available,
                                      v4_kernel_available)
from defensegan_torch.kernels.loop import ROW_TILE
from defensegan_torch.gan.train import (GANState, init_gan_state,
                                        make_data_train_step)
from defensegan_torch.models import critic_for, encoder_for, \
    from_image_space, generator_for, to_image_space
from defensegan_torch.utils.misc import append_jsonl, ensure_dir, fold_seed
from defensegan_torch.utils.profiling import recording, span
from defensegan_torch.utils.visualize import save_images

PROJECTION_KERNELS = ("auto", "xla", "packed", "pallas", "pallas_int8",
                      "pallas_v4")
# the fused loops a resolved path runs on, by name, and their reconstructors
LOOPS = {"v2": make_dense_reconstructor, "v2i": make_dense_int8_reconstructor,
         "v3": make_s2d_reconstructor, "v4": make_v4_reconstructor}


def _dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "bf16": torch.bfloat16, "f32": torch.float32}[name.lower()]


def default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU; pass "
                           "device='cpu' explicitly to run on the CPU")
    return torch.device("cuda")


def process_group():
    """The default process group when this process is one rank of a
    torch.distributed group (initialize_distributed), else None."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def writes_files() -> bool:
    """Whether this process writes run files: always in one process, only
    rank 0 in a process group."""
    return process_group() is None or dist.get_rank() == 0


def resolve_projection_kernel(gan, *, back_prop: bool = False,
                              requested: Optional[str] = None,
                              on_cuda: Optional[bool] = None) -> str:
    """The projection path that actually runs for this call.

    Takes the JAX package's PROJECTION_KERNEL values; returns 'pallas'
    (a bf16 fused CUDA kernel: v2 for wide single-deconv generators within
    the dense-packing bound, v3 for two-deconv deep ones), 'pallas_int8'
    (v2's int8 variant, v2i), 'pallas_v4' (the multi-deconv loop, v4: the
    64x64 stacks, and the two-deconv deep generator as its edge case),
    'packed' or 'xla' (plain PyTorch paths). On CUDA with back_prop=False,
    'auto' and 'pallas' run the generator's kernel at any batch size (the
    kernel wrappers pad the rows to the kernels' tile); 'pallas_int8' runs
    v2i on a wide generator and the bf16 v3 on a deep one (there is no int8
    deep loop, as in the JAX package). On CUDA with back_prop=False 'auto'
    takes 'pallas' where v2 or v3 covers the generator, else 'pallas_v4'
    where v4 does (the 64x64 stacks): there v4 runs 3.34x the plain path,
    and the benchmark's celeba cell holds its answers to the float32
    reference. This departs from the JAX package, whose 'auto' never takes
    v4, so that its 'auto' is 'xla' on a 64x64 stack. Elsewhere 'auto',
    and any request on the CPU, resolves to the plain per-topology path:
    'packed' for single-deconv generators, 'xla' for deeper ones; under
    back_prop that is the differentiable path. An explicit kernel request
    that cannot run on CUDA raises: under back_prop (the kernels have no
    backward pass; the JAX resolver degrades such a request to the plain
    path instead, which the port does not do quietly), and on a generator
    the requested kernel does not cover ('pallas' / 'pallas_int8' on a
    64x64 stack, which 'pallas_v4' serves; 'pallas_v4' on a
    single-deconv generator).
    """
    return _resolve(gan, back_prop=back_prop, requested=requested,
                    on_cuda=on_cuda)[0]


def _resolve(gan, *, back_prop: bool = False,
             requested: Optional[str] = None,
             on_cuda: Optional[bool] = None) -> Tuple[str, str]:
    """(path, loop): the path `resolve_projection_kernel` returns and
    what serves it, one of LOOPS ('v2', 'v2i', 'v3', 'v4') on a kernel
    path, the path itself ('packed', 'xla') on a plain one."""
    if requested is None:
        requested = gan.cfg.projection_kernel
    if requested not in PROJECTION_KERNELS:
        raise ValueError(f"unknown projection kernel {requested!r}")
    if on_cuda is None:
        on_cuda = gan.device.type == "cuda"
    channels = gan.generator.channels
    xla_best = "packed" if len(channels) == 1 else "xla"
    dense_ok = dense_kernel_available(gan.generator)
    s2d_ok = s2d_kernel_available(gan.generator)
    v4_ok = v4_kernel_available(gan.generator)
    if requested == "auto":
        if on_cuda and not back_prop:
            if dense_ok:
                return "pallas", "v2"
            if s2d_ok:
                return "pallas", "v3"
            if v4_ok:
                return "pallas_v4", "v4"
        return xla_best, xla_best
    if requested in ("xla", "packed"):
        return requested, requested
    if not on_cuda:
        return xla_best, xla_best
    if back_prop:
        raise NotImplementedError(
            f"{requested!r} has no backward pass: under back_prop=True "
            "request 'auto', 'packed' or 'xla' (the differentiable paths)")
    if requested == "pallas_v4":
        if v4_ok:
            return requested, "v4"
        raise NotImplementedError(
            f"'pallas_v4' covers multi-deconv generators up to "
            f"channels[0] = 768, not channels {channels}; a single-deconv "
            "generator has the dense kernels ('pallas', 'pallas_int8')")
    if dense_ok:
        return requested, "v2i" if requested == "pallas_int8" else "v2"
    if s2d_ok:
        return "pallas", "v3"     # deep topologies: the bf16 v3 only
    raise NotImplementedError(
        f"{requested!r}: no ported kernel covers this generator under that "
        f"name (channels {channels}, base {gan.generator.base_hw}); the "
        "dense kernels take single-deconv generators up to 16384 features, "
        "the s2d kernel two-deconv ones"
        + (", and 'pallas_v4' serves this one" if v4_ok else ""))


class _Graphed:
    """A reconstruct call's device work captured once as a CUDA graph and
    replayed, so that the host issues one launch where the eager call
    issues one an operation (~340 for one image at R 2 and L 50, with
    the encoder start). Each call copies its x and z0 into the graph's
    own, and clones the result out of the graph's memory; the library
    calls each replay makes are added to build.LAUNCHES and build.SLABS,
    as the eager call adds them."""

    def __init__(self, run, x: torch.Tensor, z0: torch.Tensor):
        self.x, self.z0 = x.clone(), z0.clone()
        counters = (build.LAUNCHES, build.SLABS)
        start = [collections.Counter(c) for c in counters]
        # one eager run first, on a side stream as capture wants: the
        # libraries' handles and the kernels' attributes are set outside
        # the graph
        here = torch.cuda.current_stream(x.device)
        side = torch.cuda.Stream(x.device)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            run(self.x, self.z0)
        here.wait_stream(side)
        before = [collections.Counter(c) for c in counters]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = run(self.x, self.z0)
        # the capture's counts are each replay's; neither it nor the
        # warm-up run is the call's work (its replay, below, is)
        self.counts = []
        for counter, old, first in zip(counters, before, start):
            self.counts.append((counter, counter - old))
            counter.subtract(counter - first)

    def __call__(self, x: torch.Tensor, z0: torch.Tensor
                 ) -> ReconstructionResult:
        self.x.copy_(x)
        self.z0.copy_(z0)
        self.graph.replay()
        for counter, delta in self.counts:
            counter.update(delta)
        return self.out._make(t.clone() for t in self.out)


class DefenseGAN:
    """WGAN generator (+ critic for training) + Defense-GAN projection for
    one config."""

    def __init__(self, cfg: Config, device=None, seed: Optional[int] = None):
        self.cfg = cfg
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.dtype = _dtype_of(cfg.compute_dtype)
        self.seed = cfg.seed if seed is None else seed
        init = torch.Generator().manual_seed(self.seed)
        self.generator = generator_for(
            cfg.type, cfg.gen_dim, self.dtype, cfg.gen_arch,
            cfg.latent_dim, gen=init).to(self.device).requires_grad_(False)
        self.critic = None            # built by training or an export
        self.encoder = None
        self.state: Optional[GANState] = None     # training state
        self.step: Optional[int] = None
        self.last_kernel: Optional[str] = None   # path of the last call
        self._train_step = None       # late-bound: tests substitute it
        self._train_gen: Optional[torch.Generator] = None
        self._reconstructors: Dict[Tuple, callable] = {}
        self._graphs: Dict[Tuple, _Graphed] = {}
        # counts the rebinds of the weights (load, restore, train, a new
        # encoder): wrappers that copy them (parallel/serving.py) re-copy
        # when it moves
        self.weights_version = 0

    def weights_changed(self) -> None:
        """Call after changing the weights in place: the kernels'
        reconstructors pack the weights they were built on (dropped here),
        and copies of the weights (parallel/serving.py) refresh."""
        self._reconstructors.clear()
        self._graphs.clear()
        self.weights_version += 1

    # ------------------------------------------------------------------ gen
    def gen_apply_tanh(self, z: torch.Tensor) -> torch.Tensor:
        """Frozen generator in inference mode (BN running averages)."""
        return self.generator(z)

    @torch.no_grad()
    def generate(self, gen: Optional[torch.Generator], n: int
                 ) -> torch.Tensor:
        """n samples in [0, 1] image space, NHWC."""
        z = torch.randn((n, self.cfg.latent_dim), generator=gen,
                        device=gen.device if gen is not None else "cpu")
        return to_image_space(self.generator(z.to(self.device)))

    # ------------------------------------------------------------ weights
    def load(self, step: Optional[int] = None) -> "DefenseGAN":
        """Load the run's weight export (latest step when None): the
        generator and, when the export has them, the critic and the
        encoder."""
        tree = read_export(export_path(self.cfg.output_dir, step))
        g = tree["generator"]
        load_flax_tree(self.generator, g["params"], g.get("batch_stats"))
        if "critic" in tree:
            load_flax_tree(self._build_critic(), tree["critic"]["params"])
        if "encoder" in tree:
            load_flax_tree(self._build_encoder(), tree["encoder"]["params"])
        self.step = tree.get("manifest", {}).get("step", step)
        self.weights_changed()
        return self

    def _build_critic(self):
        if self.critic is None:
            init = torch.Generator().manual_seed(self.seed + 1)
            self.critic = critic_for(
                self.cfg.type, self.cfg.disc_dim, self.dtype,
                gen=init).to(self.device).requires_grad_(False)
        return self.critic

    def _build_encoder(self):
        if self.encoder is None:
            self.encoder = encoder_for(
                self.cfg.type, self.cfg.disc_dim, z_dim=self.cfg.latent_dim,
                dtype=self.dtype).to(self.device).requires_grad_(False)
        return self.encoder

    def has_encoder(self) -> bool:
        return self.encoder is not None

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """E(x) -> z [B, k]; x in [0, 1] image space (or uint8)."""
        if self.encoder is None:
            raise RuntimeError("no encoder loaded: the run's export has none")
        return self.encoder(from_image_space(x)).to(torch.float32)

    def can_load(self) -> bool:
        """Whether the run has a weight export to load (a trained GAN)."""
        try:
            export_path(self.cfg.output_dir)
        except FileNotFoundError:
            return False
        return True

    def can_restore(self) -> bool:
        """Whether the run has a training checkpoint to resume from."""
        return latest_step(self.cfg.output_dir) is not None

    # ------------------------------------------------------------ training
    def _train_state(self) -> GANState:
        if self.state is None:
            cfg = self.cfg
            self.state = init_gan_state(
                self.generator, self._build_critic(),
                gen_lr=cfg.gen_learning_rate,
                disc_lr=cfg.disc_learning_rate, beta1=cfg.beta1,
                beta2=cfg.beta2)
            self.state.step = self.step or 0
            self._train_gen = torch.Generator(device=self.device) \
                .manual_seed(self.seed)
        return self.state

    def _set_trainable(self, on: bool) -> None:
        self.generator.requires_grad_(on)
        self.critic.requires_grad_(on)

    def train(self, images: np.ndarray, *,
              train_iters: Optional[int] = None, log_every: int = 100,
              quiet: bool = False,
              on_divergence: str = "restore") -> Dict[str, float]:
        """Train the WGAN-GP (reference: gan.train()) up to step
        `train_iters` (default cfg.train_iters) from the current step: a
        run restored from its checkpoint continues where it stopped, with
        the same draws an unbroken run would make.

        images: [N, H, W, C] float32 in [0, 1], or uint8, moved to the
        device once; every step draws its minibatches there. The host
        reads the metrics only at the next log / sample / save boundary
        (reading them waits for the device) and checks them for
        divergence at every boundary. on_divergence="restore" reloads the
        latest checkpoint, reseeds the draws (JAX's fold_in(key, it)) and
        carries on counting; "raise" raises RuntimeError. At each log
        boundary a line goes to <output_dir>/metrics.jsonl, at each
        sample boundary a grid to samples/, at each save boundary `save`
        runs. Returns the last finite metrics and train_steps_per_s.

        In a process group (initialize_distributed; one rank per device)
        the step is data parallel on the global batch, as the JAX
        package's train(mesh=...): every rank holds the dataset and the
        same draw generator, trains on its 1/world of cfg.batch_size with
        the global batch's BatchNorm statistics and averaged gradients,
        so each step equals the single-process one. Only rank 0 writes
        (metrics, samples, checkpoints, the export).
        """
        if on_divergence not in ("restore", "raise"):
            raise ValueError(f"on_divergence {on_divergence!r}: 'restore' "
                             "or 'raise'")
        cfg = self.cfg
        iters = train_iters if train_iters is not None else cfg.train_iters
        group = process_group()
        writer = writes_files()
        state = self._train_state()
        if self._train_step is None:
            self._train_step = make_data_train_step(
                state, latent_dim=cfg.latent_dim, batch_size=cfg.batch_size,
                disc_iters=cfg.disc_iters, gp_lambda=cfg.gp_lambda,
                group=group)
        if writer:
            ensure_dir(cfg.output_dir)
            save_config(cfg)
        data = torch.as_tensor(images if images.dtype == np.uint8
                               else np.asarray(images, np.float32),
                               device=self.device)

        def at(it, every):
            return (every > 0 and it % every == 0) or it == iters

        def next_boundary(it):
            nxt = iters
            for every in (log_every, cfg.sample_every, cfg.save_every):
                if every > 0:
                    nxt = min(nxt, (it // every + 1) * every)
            return max(nxt - it, 1)

        metrics: Dict = {}
        last_good: Dict[str, float] = {}
        it = start = state.step
        self._set_trainable(True)
        t0 = time.perf_counter()
        try:
            while it < iters:
                for _ in range(next_boundary(it)):
                    metrics = self._train_step(data, self._train_gen)
                    it += 1
                m = {k: float(v) for k, v in metrics.items()}
                if not all(np.isfinite(v) for v in m.values()):
                    if on_divergence == "raise" or not self.can_restore():
                        raise RuntimeError(
                            f"training diverged at step {it}: {m}")
                    print(f"[{cfg.type}] step {it}: non-finite metrics "
                          f"{m}; restoring the latest checkpoint")
                    self.restore()
                    self._train_gen.manual_seed(
                        fold_seed(self._train_gen.initial_seed(), it))
                    # the sample and save below run on the restored state
                    metrics = dict(last_good)
                elif at(it, log_every):
                    last_good = m
                    if writer:
                        append_jsonl(os.path.join(cfg.output_dir,
                                                  "metrics.jsonl"),
                                     dict(m, step=it,
                                          wall_s=time.perf_counter() - t0))
                    if writer and not quiet:
                        print(f"[{cfg.type}] step {it}/{iters} "
                              f"w={m.get('wasserstein', 0):+.4f} "
                              f"g={m.get('g_loss', 0):+.4f} "
                              f"gp={m.get('gp', 0):.4f}")
                self.step = state.step
                if writer and at(it, cfg.sample_every):
                    self.save_samples(os.path.join(
                        cfg.output_dir, "samples", f"sample_{it:07d}.png"))
                if at(it, cfg.save_every):
                    self.save()
        finally:
            self._set_trainable(False)
            self.weights_changed()
        out = {k: float(v) for k, v in metrics.items()}
        wall = time.perf_counter() - t0
        if wall > 0 and it > start:
            out["train_steps_per_s"] = (it - start) / wall
            if writer and not quiet:
                print(f"[{cfg.type}] {it - start} steps in {wall:.1f}s "
                      f"({out['train_steps_per_s']:.2f} generator steps/s)")
        return out

    def save_samples(self, path: str) -> str:
        """A grid of 64 samples of the current generator (inference mode),
        the same latents at every call (seeded from the run's seed)."""
        gen = torch.Generator(device=self.device).manual_seed(
            fold_seed(self.seed, 1))
        return save_images(self.generate(gen, 64).cpu().numpy(), path)

    def save(self) -> Optional[str]:
        """Checkpoint the training state as <output_dir>/checkpoints/
        <step>.pt and write the weight export <output_dir>/export/
        <step>.npz that `load` reads (reference: base_model.save). In a
        process group rank 0 writes, every rank waits for it, and the
        other ranks get None."""
        state = self._train_state()
        self.step = state.step
        path = None
        if writes_files():
            save_config(self.cfg)
            path = save_checkpoint(self.cfg.output_dir, state.step,
                                   dict(state.state_dict(),
                                        rng=self._train_gen.get_state()))
            self.write_export({"checkpoint": path})
        if process_group() is not None:
            dist.barrier()
        return path

    def restore(self, step: Optional[int] = None) -> "DefenseGAN":
        """Resume the training state from <output_dir>/checkpoints/
        <step>.pt (the latest when None), the draw generator included."""
        state = self._train_state()
        # read to the host: the modules and Adam copy their tensors to the
        # parameters' device, and Adam's step counts and the generator
        # state must stay CPU tensors
        ckpt = restore_checkpoint(self.cfg.output_dir, step,
                                  map_location="cpu")
        state.load_state_dict(ckpt)
        self._train_gen.set_state(ckpt["rng"])
        self.step = state.step
        self.weights_changed()
        return self

    def write_export(self, sources: Optional[Dict] = None) -> str:
        """Write the weight export of the current step: the generator with
        its BatchNorm statistics, and the critic and the encoder when the
        model has them."""
        modules = {"generator": self.generator}
        if self.critic is not None:
            modules["critic"] = self.critic
        if self.encoder is not None:
            modules["encoder"] = self.encoder
        return write_export(self.cfg.output_dir, self.step, modules, {
            "config": self.cfg.to_yaml_dict(), "package": "defensegan_torch",
            "sources": sources or {}})

    def train_encoder(self, images: np.ndarray, *,
                      iters: Optional[int] = None,
                      gen: Optional[torch.Generator] = None,
                      quiet: bool = False, **kw) -> Dict[str, float]:
        """Train a fresh amortized-inversion encoder E(x) -> z against the
        FROZEN current generator (defense/encoder_init.py), and write it
        into the run's weight export at the generator's step, which
        `load` reads back (rec_init encoder / encoder_jitter). Retraining
        the GAN stales the encoder: train it again after `train`."""
        from defensegan_torch.defense.encoder_init import train_encoder
        cfg = self.cfg
        if self.step is None:
            raise RuntimeError("train_encoder inverts a trained generator: "
                               "load() or train() first")
        enc = encoder_for(cfg.type, cfg.disc_dim, z_dim=cfg.latent_dim,
                          dtype=self.dtype,
                          gen=torch.Generator().manual_seed(self.seed + 2)
                          ).to(self.device)
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(
                fold_seed(self.seed, 2))
        self.encoder, metrics = train_encoder(
            enc, self.gen_apply_tanh, images, gen,
            iters=iters if iters is not None else cfg.encoder_train_iters,
            batch_size=kw.pop("batch_size", cfg.encoder_batch),
            lr=kw.pop("lr", cfg.encoder_lr),
            beta_z=kw.pop("beta_z", cfg.encoder_beta_z),
            noise_aug=kw.pop("noise_aug", cfg.encoder_noise_aug),
            quiet=quiet, **kw)
        self.weights_changed()
        if writes_files():
            self.write_export()
        if process_group() is not None:
            dist.barrier()
        return metrics

    # -------------------------------------------------------------- defense
    def reconstruct(self, x, gen: Optional[torch.Generator] = None, *,
                    rec_rr: Optional[int] = None,
                    rec_iters: Optional[int] = None,
                    rec_lr: Optional[float] = None,
                    back_prop: bool = False,
                    kernel: Optional[str] = None,
                    init: Optional[str] = None,
                    z0: Optional[torch.Tensor] = None
                    ) -> ReconstructionResult:
        """Project x ([B, H, W, C] in [0, 1], or uint8) onto the generator
        manifold.

        gen: torch.Generator for the restart draws (default: seeded with
        cfg.seed + 1 on the model's device). z0 ([B, R, k]) replaces the
        draws. Under init "random" it is projected as given; under
        "encoder" or "encoder_jitter" too, except that a row whose
        restart 0 holds a NaN starts that restart at the model's own E(x)
        (chosen on the device, no host sync). JAX's reconstruct takes no
        table; its encoder init is the z0=None path. kernel overrides
        cfg.projection_kernel and init cfg.rec_init for this call; the
        path that ran is left in `self.last_kernel`. back_prop=True
        returns a result differentiable with respect to x through the
        unrolled loop (defense/project.py) and through E(x) where the
        encoder starts a restart, on the path the resolver picks for it
        ('auto' -> 'packed' or 'xla'); otherwise nothing in the result
        carries gradients. A call on a fused loop whose rows (B x R) fit
        one row tile (ROW_TILE), with draws, and without back_prop,
        replays a CUDA graph of its device work (encoder start, loop,
        selection), captured at the first call of its shapes and
        dropped by weights_changed: such a request is launch-bound.
        Under a torch.profiler every call runs eagerly, so that its spans
        see each layer: a gan.reconstruct span around projection.encode
        (the encoder start, when the encoder runs) and the
        reconstructor's projection.loop and projection.select.
        """
        cfg = self.cfg
        rr = rec_rr if rec_rr is not None else cfg.rec_rr
        iters = rec_iters if rec_iters is not None else cfg.rec_iters
        lr = rec_lr if rec_lr is not None else cfg.rec_lr
        init = init if init is not None else cfg.rec_init
        if init not in ("random", "encoder", "encoder_jitter"):
            raise ValueError(f"unknown rec_init {init!r}")
        with span("gan.reconstruct"):
            x = torch.as_tensor(x, device=self.device)
            if gen is None:
                gen = torch.Generator(device=self.device).manual_seed(
                    cfg.seed + 1)
            path, loop = _resolve(self, requested=kernel,
                                  back_prop=back_prop)
            fn = self._reconstructor_for(loop, rr, iters, lr, back_prop)
            self.last_kernel = path
            with torch.set_grad_enabled(back_prop):
                if z0 is None and init == "random":
                    z0 = sample_z0(gen, x.shape[0], rr, cfg.latent_dim)
                if z0 is not None:
                    z0 = z0.to(self.device, torch.float32)

                def run(x, z0):
                    if init != "random":
                        z0 = self._encoder_z0(x, gen, rr, init, z0)
                    return fn(x, z0=z0)

                if z0 is None or loop not in LOOPS or back_prop or \
                        x.shape[0] * rr > ROW_TILE or recording():
                    return run(x, z0)
                key = (loop, rr, iters, lr, init, x.shape, x.dtype,
                       z0.shape)
                if key not in self._graphs:
                    self._graphs[key] = _Graphed(run, x, z0)
                return self._graphs[key](x, z0)

    def _encoder_z0(self, x, gen, rr: int, mode: str,
                    z0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The encoder start [B, R, k]: with no table, E(x) and the draws
        of `mode`; with one, the table with E(x) in restart 0 of the rows
        whose restart 0 holds a NaN. Differentiable through E when the
        caller enables gradients."""
        from defensegan_torch.defense.encoder_init import encoder_z0
        if self.encoder is None:
            raise RuntimeError(
                f"rec_init={mode!r} needs a trained encoder in the run's "
                f"weight export ({self.cfg.output_dir}/export)")
        with span("projection.encode"):
            if z0 is None:
                return encoder_z0(self.encoder, x, gen, rec_rr=rr, mode=mode,
                                  sigma=self.cfg.encoder_sigma)
            z_enc = self.encoder(from_image_space(x)).to(torch.float32)
            nan = torch.isnan(z0[:, :1]).any(dim=2, keepdim=True)
            start = torch.where(nan, z_enc[:, None], z0[:, :1])
            return torch.cat([start, z0[:, 1:]], dim=1)

    def _reconstructor_for(self, loop: str, rr: int, iters: int,
                           lr: float, back_prop: bool = False):
        """Build (or fetch from the cache) f(x, z0=...) for a RESOLVED
        loop (`_resolve`: a fused loop of LOOPS, 'packed' or 'xla').
        Builders pack the current weights; load() clears the cache.
        back_prop reaches the plain paths only: the resolver never hands a
        kernel path over under back_prop."""
        sig = (loop, rr, iters, lr, back_prop)
        if sig in self._reconstructors:
            return self._reconstructors[sig]
        cfg = self.cfg
        if loop in LOOPS:
            fn = LOOPS[loop](self.generator, cfg.image_shape, rec_rr=rr,
                             rec_iters=iters, rec_lr=lr,
                             momentum=cfg.rec_momentum)
        elif loop == "packed":
            # For s2d the loop runs in space-to-depth pixel order (MSE is
            # permutation-invariant); the un-shuffle is one gather outside
            from defensegan_torch.defense.fastgen import (make_packed_apply,
                                                          pack_generator)
            variant = cfg.packed_variant
            if variant == "auto":
                variant = ("conv" if cfg.gen_arch == "wide"
                           else "s2d" if len(self.generator.channels) == 2
                           else "conv")
            packed = pack_generator(self.generator, variant)
            apply_flat = make_packed_apply(packed)
            perm = packed.perm

            def fn(x, z0):
                x_flat = x.reshape(x.shape[0], -1)
                if perm:
                    x_flat = x_flat[:, perm[0]]
                res = reconstruct(apply_flat, x_flat, z0, rec_iters=iters,
                                  rec_lr=lr, momentum=cfg.rec_momentum,
                                  back_prop=back_prop)
                x_hat = res.x_hat[:, perm[1]] if perm else res.x_hat
                return res._replace(x_hat=x_hat.reshape(x.shape))
        else:
            def fn(x, z0):
                return reconstruct(self.generator, x, z0, rec_iters=iters,
                                   rec_lr=lr, momentum=cfg.rec_momentum,
                                   back_prop=back_prop)
        self._reconstructors[sig] = fn
        return fn
