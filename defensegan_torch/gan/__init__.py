"""The user-facing DefenseGAN model (inference)."""

from defensegan_torch.gan.defense_gan import (DefenseGAN,
                                              resolve_projection_kernel)

__all__ = ["DefenseGAN", "resolve_projection_kernel"]
