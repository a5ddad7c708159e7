"""Weights for the port: the numpy export (a JAX run's, or one the port
trained) and its bridge both ways, and the port's own torch checkpoints
(the full training state, the classifier cache)."""

from defensegan_torch.ckpt.bridge import (export_path, flax_tree,
                                          load_flax_tree, read_export,
                                          write_export)
from defensegan_torch.ckpt.checkpoint import (latest_step,
                                              restore_checkpoint,
                                              save_checkpoint)

__all__ = ["export_path", "flax_tree", "load_flax_tree", "read_export",
           "write_export", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
