"""The Defense-GAN projection core, packed generators and serving pipeline."""

from defensegan_torch.defense.project import (ReconstructionResult,
                                              make_reconstructor,
                                              reconstruct, sample_z0)

__all__ = ["ReconstructionResult", "make_reconstructor", "reconstruct",
           "sample_z0"]
