"""Weights for the port: the numpy export of a JAX run and its bridge, and
the port's own torch checkpoints (the classifier cache)."""

from defensegan_torch.ckpt.bridge import (export_path, load_flax_tree,
                                          read_export)
from defensegan_torch.ckpt.checkpoint import (latest_step,
                                              restore_checkpoint,
                                              save_checkpoint)

__all__ = ["export_path", "load_flax_tree", "read_export", "latest_step",
           "restore_checkpoint", "save_checkpoint"]
