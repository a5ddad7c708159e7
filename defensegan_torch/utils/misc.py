"""Path and record helpers (port of the JAX package's utils/misc.py), and
the seed rules every random stream of the port follows.

Keys. The JAX package threads PRNG keys (fold_in, split); the port
threads integer seeds with the same structure: `fold_seed(seed, i)` gives
a distinct stream per (seed, i) path, as fold_in does, and every draw is
made from a torch.Generator seeded with such a seed on the tensors'
device. The two frameworks' streams differ, so every function that draws
also takes the draw (or a function making it) as an argument: tests pass
JAX's draws in.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch


def ensure_dir(path: str) -> str:
    """mkdir -p and return the path."""
    os.makedirs(path, exist_ok=True)
    return path


def append_jsonl(path: str, record: Dict[str, Any]) -> None:
    """Append one JSON line to `path`, creating its directory."""
    ensure_dir(os.path.dirname(path) or ".")
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def fold_seed(seed: int, *data: int) -> int:
    """A 63-bit seed for the stream (seed, *data) (jax.random.fold_in's
    role): distinct paths give unrelated seeds."""
    words = np.random.SeedSequence([int(seed), *map(int, data)]) \
        .generate_state(2, np.uint32)
    return (int(words[0]) << 31 | int(words[1]) >> 1) & (2 ** 63 - 1)


def generator_for(seed: int, device) -> torch.Generator:
    """A torch.Generator on `device` seeded with `seed`."""
    return torch.Generator(device=device).manual_seed(int(seed))
