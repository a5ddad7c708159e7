"""Shared CLI plumbing: --cfg resolution, config overrides, the device, model
and data loading (port of the JAX package's cli/common.py).

Reference parity: the flag blocks at the top of train.py / whitebox.py /
blackbox.py of kabkabm/defensegan and utils/config.py's cfg resolution.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
from typing import Optional

import numpy as np
import torch
import yaml

from defensegan_torch.configs import Config, load_config
from defensegan_torch.data import get_dataset
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.gan.defense_gan import default_device

DEFAULT_CFG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "gans", "mnist.yml")


def add_cfg_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--cfg", default=DEFAULT_CFG,
                    help="YAML config or a trained run's output dir")
    ap.add_argument("--rec_iters", type=int, default=None)
    ap.add_argument("--rec_rr", type=int, default=None)
    ap.add_argument("--rec_lr", type=float, default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--train_iters", type=int, default=None)
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--data_dir", default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--override", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="extra config overrides (any UPPERCASE YAML key)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the models run on (default cuda: "
                    "the card; pass cpu to run on the CPU)")


def cfg_from_args(args: argparse.Namespace) -> Config:
    overrides = {}
    for name in ("rec_iters", "rec_rr", "rec_lr", "batch_size",
                 "train_iters", "output_dir", "data_dir", "seed"):
        v = getattr(args, name, None)
        if v is not None:
            overrides[name] = v
    for kv in args.override:
        k, _, v = kv.partition("=")
        try:
            overrides[k.lower()] = yaml.safe_load(v)
        except yaml.YAMLError:
            overrides[k.lower()] = v
    return load_config(args.cfg, overrides)


def device_from_args(args: argparse.Namespace) -> torch.device:
    """The requested device; 'cuda' without a CUDA device raises (no
    fallback to the CPU)."""
    if args.device == "cuda":
        return default_device()
    return torch.device(args.device)


def device_record(device: torch.device) -> dict:
    """The device a result was measured on: the card's name and power
    limit as nvidia-smi reports them, or the CPU."""
    if device.type != "cuda":
        return {"type": "cpu", "name": "cpu", "power_limit": None}
    rec = {"type": "cuda", "name": torch.cuda.get_device_name(device),
           "power_limit": None}
    if shutil.which("nvidia-smi"):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30)
        if out.returncode == 0:
            rec["nvidia_smi"] = out.stdout.strip()
            rec["power_limit"] = out.stdout.strip().split(",")[-1].strip()
    return rec


def load_gan(cfg: Config, device, require_trained: bool) -> DefenseGAN:
    """DefenseGAN on `device` with the run's weight export loaded.

    require_trained: refuse (SystemExit) a run with no export, whose
    generator would be its random init: the port never defends or detects
    with an untrained GAN."""
    gan = DefenseGAN(cfg, device=device)
    if gan.can_load():
        gan.load()
        print(f"loaded GAN weight export (step {gan.step}) from "
              f"{cfg.output_dir}")
    elif require_trained:
        raise SystemExit(
            f"no trained GAN under {cfg.output_dir}: the defense and the "
            f"detector need the run's weight export ({cfg.output_dir}/"
            f"export/<step>.npz, written by "
            f"scripts/export_torch_weights.py)")
    return gan


def load_data(cfg: Config):
    return get_dataset(cfg.type, data_dir=cfg.data_dir, seed=cfg.seed)


def limit(x: np.ndarray, y: np.ndarray, n: Optional[int]):
    if n is None or n <= 0 or n >= x.shape[0]:
        return x, y
    return x[:n], y[:n]
