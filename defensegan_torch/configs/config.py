"""Typed config + YAML loading with reference-compatible UPPERCASE keys.

The PyTorch port's own copy of the JAX package's `configs/config.py` (the
port imports nothing of the JAX package), so the same YAML files drive
both packages. YAML keys are UPPERCASE (TYPE, BATCH_SIZE, LATENT_DIM,
REC_ITERS, REC_RR, REC_LR, PROJECTION_KERNEL, ...); `load_config` accepts a
trained run's output directory and re-loads the cfg stored there, mirroring
the reference's `--cfg <output-dir>` convention.

PROJECTION_KERNEL takes the JAX package's values; in the port `pallas`
names the hand-written CUDA kernel for the same loop (fused_projection_v2,
or fused_projection_v3 on a two-deconv deep generator) and `pallas_int8`
v2's int8 variant (fused_projection_v2i); `pallas_v4`
names the multi-deconv loop of the 64x64 configs (fused_projection_v4). See
gan/defense_gan.py::resolve_projection_kernel.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import yaml

CFG_FILENAME = "cfg.yml"


@dataclass
class Config:
    """All knobs of the pipeline. YAML key = UPPERCASE of the field name."""

    # --- dataset / architecture ---
    type: str = "mnist"              # TYPE: mnist | f-mnist | celeba
    image_size: int = 28             # IMAGE_SIZE
    channels: int = 1                # CHANNELS
    num_classes: int = 10            # NUM_CLASSES
    latent_dim: int = 128            # LATENT_DIM (z dimension)
    gen_dim: int = 64                # GEN_DIM (generator width multiplier)
    gen_arch: str = "deep"           # GEN_ARCH: deep | wide (generator_for)
    disc_dim: int = 64               # DISC_DIM (critic width multiplier)

    # --- WGAN-GP training (canonical values from arXiv:1704.00028) ---
    mode: str = "wgan-gp"            # MODE
    batch_size: int = 64             # BATCH_SIZE
    train_iters: int = 20000         # TRAIN_ITERS (generator updates)
    disc_iters: int = 5              # DISC_ITERS (critic steps per gen step)
    gp_lambda: float = 10.0          # GP_LAMBDA (gradient-penalty weight)
    gen_learning_rate: float = 1e-4  # GEN_LEARNING_RATE (Adam)
    disc_learning_rate: float = 1e-4 # DISC_LEARNING_RATE (Adam)
    beta1: float = 0.5               # BETA1
    beta2: float = 0.9               # BETA2

    # --- Defense-GAN projection (reference defaults R=10, L=200, lr=10) ---
    rec_iters: int = 200             # REC_ITERS (L)
    rec_rr: int = 10                 # REC_RR (R random restarts)
    rec_lr: float = 10.0             # REC_LR
    rec_momentum: float = 0.7        # REC_MOMENTUM
    rec_unroll: int = 8              # REC_UNROLL (JAX scan unroll; read,
    #   not used by the port)
    rec_init: str = "random"         # REC_INIT: random | encoder |
    #   encoder_jitter — z0 policy for the projection. "random" is the
    #   reference's N(0, I) restarts (default; the other values are an
    #   extension — defense/encoder_init.py). encoder* need a trained
    #   encoder in the run's weight export.
    encoder_sigma: float = 0.5       # ENCODER_SIGMA (jitter std, rec_init=
    #   encoder_jitter: restarts 1..R-1 = E(x) + sigma * N(0, I))

    # --- encoder training (rec_init=encoder*; defense/encoder_init.py) ---
    encoder_train_iters: int = 3000  # ENCODER_TRAIN_ITERS
    encoder_lr: float = 1e-3         # ENCODER_LR (Adam)
    encoder_batch: int = 128         # ENCODER_BATCH
    encoder_beta_z: float = 0.5      # ENCODER_BETA_Z (latent-cycle weight)
    encoder_noise_aug: float = 0.0   # ENCODER_NOISE_AUG (L-inf train noise)

    # --- compute ---
    compute_dtype: str = "bfloat16"  # COMPUTE_DTYPE: float32 | bfloat16
    projection_kernel: str = "auto"  # PROJECTION_KERNEL:
    #   auto   = on CUDA the bf16 fused kernel: v2 for wide single-deconv
    #            archs, v3 for two-deconv deep ones, v4 (pallas_v4) for
    #            the 64x64 stacks; the plain per-topology path on the CPU
    #            and under back_prop (packed for single-deconv, xla for
    #            deeper stacks)
    #   xla    = generator module in the autograd loop (defense/project.py)
    #   packed = BN-folded flat-space generator (defense/fastgen.py)
    #   pallas = bf16 fused RxL loop: v2 (kernels/fused_projection_v2.py)
    #            on a wide generator, v3 (fused_projection_v3.py) on a
    #            two-deconv deep one
    #   pallas_int8 = OPT-IN int8 fused loop for wide archs
    #            (kernels/fused_projection_v2i.py); opt-in because
    #            quantized defense quality is gated per checkpoint
    #            (the int8_gate.json criterion) rather than assumed
    #   pallas_v4 = fused loop for multi-deconv generators, the 64x64
    #            stacks (kernels/fused_projection_v4.py); what auto takes
    #            there on CUDA, where the JAX package's auto takes xla
    #   see gan/defense_gan.py::resolve_projection_kernel
    packed_variant: str = "auto"     # PACKED_VARIANT (kernel=packed):
    #   conv | phase | dense | hybrid | s2d (defense/fastgen.py); auto =
    #   s2d on a two-deconv deep generator, conv otherwise
    seed: int = 0                    # SEED
    mesh_data_axis: int = -1         # MESH_DATA_AXIS: -1 = all local devices

    # --- io ---
    output_dir: str = ""             # OUTPUT_DIR ('' -> output/gans/<type>)
    data_dir: str = "data"           # DATA_DIR
    save_every: int = 1000           # SAVE_EVERY (ckpt cadence, gen steps)
    sample_every: int = 500          # SAMPLE_EVERY (image-grid cadence)

    extra: Dict[str, Any] = field(default_factory=dict)  # unknown YAML keys

    def __post_init__(self):
        if not self.output_dir:
            self.output_dir = os.path.join("output", "gans", self.type)

    @property
    def image_shape(self):
        return (self.image_size, self.image_size, self.channels)

    def to_yaml_dict(self) -> Dict[str, Any]:
        d = {}
        for f in dataclasses.fields(self):
            if f.name == "extra":
                continue
            d[f.name.upper()] = getattr(self, f.name)
        d.update(self.extra)
        return d

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_FIELD_NAMES = {f.name for f in dataclasses.fields(Config)}


def _from_yaml_dict(d: Dict[str, Any]) -> Config:
    kw: Dict[str, Any] = {}
    extra: Dict[str, Any] = {}
    for k, v in d.items():
        name = k.lower()
        if name in _FIELD_NAMES and name != "extra":
            kw[name] = v
        else:
            extra[k] = v
    return Config(extra=extra, **kw)


def load_config(cfg_path: str,
                overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Load a Config from a YAML file or a trained run's output directory.

    Mirrors the reference `--cfg` semantics: a directory argument resolves to
    the cfg stored inside it by a previous training run. `overrides` maps
    field names (any case) to values, playing the role of CLI flag overrides.
    """
    path = cfg_path
    if os.path.isdir(path):
        path = os.path.join(path, CFG_FILENAME)
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    if not isinstance(raw, dict):
        raise ValueError(f"config file {path!r} must contain a mapping")
    cfg = _from_yaml_dict(raw)
    if overrides:
        valid = {k.lower(): v for k, v in overrides.items() if v is not None}
        unknown = set(valid) - _FIELD_NAMES
        if unknown:
            raise ValueError(f"unknown config overrides: {sorted(unknown)}")
        cfg = cfg.replace(**valid)
    return cfg


def save_config(cfg: Config, output_dir: Optional[str] = None) -> str:
    """Store the cfg inside the run's output dir (reference convention)."""
    out = output_dir or cfg.output_dir
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, CFG_FILENAME)
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_yaml_dict(), f, sort_keys=True)
    return path
