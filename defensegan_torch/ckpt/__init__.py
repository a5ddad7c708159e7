"""Weights for the port: the numpy export of a JAX run, and its bridge."""

from defensegan_torch.ckpt.bridge import (export_path, load_flax_tree,
                                          read_export)

__all__ = ["export_path", "load_flax_tree", "read_export"]
