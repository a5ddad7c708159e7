"""Encoder-initialized projection: z0 policies (port of
defense/encoder_init.py; the encoder's training is a later slice).

    "random"          z0 ~ N(0, I)                      (reference semantics)
    "encoder"         restart 0 = E(x); restarts 1..R-1 ~ N(0, I)
    "encoder_jitter"  restart 0 = E(x); restarts 1..R-1 = E(x) + sigma * N
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from defensegan_torch.models.generator import from_image_space

Z0_MODES = ("random", "encoder", "encoder_jitter")


def encoder_z0(enc_apply: Callable[[torch.Tensor], torch.Tensor],
               x: torch.Tensor, gen: Optional[torch.Generator], *,
               rec_rr: int, mode: str = "encoder", sigma: float = 0.5,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Build [B, R, k] initial latents from an encoder.

    enc_apply: tanh-space images -> z [B, k]. x: [B, H, W, C] images in
    [0, 1] (or uint8). noise ([B, R - 1, k]) overrides the N(0, I) draws
    from `gen`, so a test can feed both packages the same numbers.
    """
    if mode not in ("encoder", "encoder_jitter"):
        raise ValueError(f"encoder_z0 mode must be 'encoder' or "
                         f"'encoder_jitter', got {mode!r}")
    z_enc = enc_apply(from_image_space(x)).to(torch.float32)     # [B, k]
    batch, z_dim = z_enc.shape
    if noise is None:
        noise = torch.randn((batch, rec_rr - 1, z_dim), generator=gen,
                            device=z_enc.device)
    rest = noise if mode == "encoder" else z_enc[:, None, :] + sigma * noise
    return torch.cat([z_enc[:, None, :], rest], dim=1)
