"""State checkpoints on torch.save / torch.load (port of the JAX package's
ckpt/checkpoint.py, whose orbax checkpoints the port never reads).

Checkpoints live at <output_dir>/checkpoints/<step>.pt; restore with
step=None loads the latest, as tf.train.latest_checkpoint does. The state
is a (nested) dict of tensors, such as a module's state_dict(); it is
loaded with weights_only=True, so a checkpoint cannot run code.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

_SUBDIR = "checkpoints"
_SUFFIX = ".pt"


def _ckpt_root(output_dir: str) -> str:
    return os.path.abspath(os.path.join(output_dir, _SUBDIR))


def latest_step(output_dir: str) -> Optional[int]:
    root = _ckpt_root(output_dir)
    if not os.path.isdir(root):
        return None
    steps = [int(f[:-len(_SUFFIX)]) for f in os.listdir(root)
             if f.endswith(_SUFFIX) and f[:-len(_SUFFIX)].isdigit()]
    return max(steps) if steps else None


def save_checkpoint(output_dir: str, step: int, state: Any) -> str:
    """Save `state` as <output_dir>/checkpoints/<step>.pt (written to a
    temporary name first, so a reader never sees half a file)."""
    root = _ckpt_root(output_dir)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"{int(step)}{_SUFFIX}")
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def restore_checkpoint(output_dir: str, step: Optional[int] = None,
                       map_location=None) -> Any:
    """Load the state saved at `step` (default: the latest)."""
    if step is None:
        step = latest_step(output_dir)
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints under {_ckpt_root(output_dir)}")
    path = os.path.join(_ckpt_root(output_dir), f"{int(step)}{_SUFFIX}")
    return torch.load(path, map_location=map_location, weights_only=True)
