"""Encoder-initialized projection: training and z0 policies (port of the
JAX package's defense/encoder_init.py).

Training (frozen generator G in inference mode; only E's parameters move):

    L(E) = mean ||G(E(x)) - x||^2                       (image term, tanh space)
         + beta_z * mean (E(G(z)) - z)^2                (latent-cycle term)
         [x drawn from the training set with replacement, optionally with
          uniform L-inf noise; z ~ N(0, I) fresh each step]

under Adam (optax.adam's defaults: betas 0.9 / 0.999, eps 1e-8). The
dataset stays on the device and each step draws its minibatch there, as
gan/train.py does; the loop reads the metrics once per chunk of steps.

z0 policies (DefenseGAN.reconstruct's rec_init):

    "random"          z0 ~ N(0, I)                      (reference semantics)
    "encoder"         restart 0 = E(x); restarts 1..R-1 ~ N(0, I)
    "encoder_jitter"  restart 0 = E(x); restarts 1..R-1 = E(x) + sigma * N
"""

from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

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


class EncoderDraws(NamedTuple):
    """One encoder step's random numbers: minibatch indices idx [B],
    latents z [B, k], and with noise_aug > 0 the U[-noise_aug, noise_aug]
    image noise [B, H, W, C]."""
    idx: torch.Tensor
    z: torch.Tensor
    noise: Optional[torch.Tensor] = None


def make_encoder_train_step(encoder: nn.Module,
                            gen_apply_tanh: Callable[[torch.Tensor],
                                                     torch.Tensor],
                            opt: torch.optim.Optimizer, *, batch_size: int,
                            beta_z: float, noise_aug: float):
    """step(data, gen, draws=None) -> metrics (device tensors): one Adam
    step of `opt` (over the encoder's parameters) on the loss above.

    gen_apply_tanh: the FROZEN generator z -> tanh images (inference mode,
    the running BatchNorm statistics: the generator the projection uses).
    data: [N, H, W, C] on the device, float32 in [0, 1] or uint8. Draws
    come from the torch.Generator `gen` unless `draws` is given.
    """

    def train_step(data: torch.Tensor, gen: Optional[torch.Generator] = None,
                   draws: Optional[EncoderDraws] = None
                   ) -> Dict[str, torch.Tensor]:
        dev = data.device
        if draws is None:
            idx = torch.randint(0, data.shape[0], (batch_size,),
                                generator=gen, device=dev)
            z = torch.randn((batch_size, encoder.z_dim), generator=gen,
                            device=dev)
            noise = None
            if noise_aug > 0.0:
                noise = (torch.rand((batch_size,) + tuple(data.shape[1:]),
                                    generator=gen, device=dev) * 2.0
                         - 1.0) * noise_aug
        else:
            idx, z, noise = draws
        x = data[idx]
        if x.dtype == torch.uint8:
            x = x.to(torch.float32) / 255.0
        x_tanh = from_image_space(x)
        x_in = x_tanh
        if noise_aug > 0.0:
            # uniform L-inf noise: the cheap stand-in for the off-manifold
            # (adversarial or corrupted) inputs the init must cope with
            x_in = torch.clamp(x_tanh + 2.0 * noise, -1.0, 1.0)
        g = gen_apply_tanh(encoder(x_in))
        img = torch.mean(torch.square((g - x_tanh).to(torch.float32)))
        cyc = torch.mean(torch.square(encoder(gen_apply_tanh(z)) - z))
        loss = img + beta_z * cyc
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return {"img_mse": img.detach(), "z_cycle": cyc.detach(),
                "loss": loss.detach()}

    return train_step


def train_encoder(encoder: nn.Module,
                  gen_apply_tanh: Callable[[torch.Tensor], torch.Tensor],
                  images: np.ndarray, gen: Optional[torch.Generator], *,
                  iters: int = 3000, batch_size: int = 128,
                  lr: float = 1e-3, beta_z: float = 0.5,
                  noise_aug: float = 0.0, chunk: int = 100,
                  quiet: bool = False
                  ) -> Tuple[nn.Module, Dict[str, float]]:
    """Train `encoder` (on its device, from its current weights) against a
    frozen generator; returns (the encoder, frozen, and its metrics).

    images: [N, H, W, C] float32 in [0, 1] or uint8, moved to the device
    once. The metrics are read once per `chunk` steps: the last chunk's
    img_mse / z_cycle / loss, `history` (one dict per chunk, with its
    step) and wall_s.
    """
    device = next(encoder.parameters()).device
    data = torch.as_tensor(images if images.dtype == np.uint8
                           else np.asarray(images, np.float32),
                           device=device)
    encoder.requires_grad_(True)
    opt = torch.optim.Adam(encoder.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    step = make_encoder_train_step(encoder, gen_apply_tanh, opt,
                                   batch_size=batch_size, beta_z=beta_z,
                                   noise_aug=noise_aug)
    t0 = time.perf_counter()
    metrics: Dict[str, float] = {}
    history = []
    done = 0
    while done < iters:
        n = min(chunk, iters - done)
        for _ in range(n):
            m = step(data, gen)
        done += n
        metrics = {k: float(v) for k, v in m.items()}
        history.append(dict(metrics, step=done))
        if not quiet:
            print(f"[encoder] step {done}/{iters} "
                  f"img_mse={metrics['img_mse']:.5f} "
                  f"z_cycle={metrics['z_cycle']:.4f}")
    metrics.update(history=history, wall_s=time.perf_counter() - t0)
    return encoder.requires_grad_(False), metrics
