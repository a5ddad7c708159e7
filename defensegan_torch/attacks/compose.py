"""Attack-through-defense composition and the per-batch seed rules (port of
the JAX package's attacks/compose.py).

One place builds the white-box "attack the unrolled defense" target
(reference: whitebox.py composing the classifier with
gan.reconstruct(back_prop=True)) and derives the per-attack-batch seeds,
so that the --eval_z0 both replay leg reproduces the attack graph's
restart draws exactly.

Keys follow utils/misc.py's seed rules (`fold_seed`, `generator_for`):
integer seeds with the structure of JAX's keys, every draw also
injectable.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from defensegan_torch.attacks.fgsm import xent_per_example
from defensegan_torch.defense.encoder_init import encoder_z0
from defensegan_torch.defense.project import reconstruct, sample_z0
from defensegan_torch.models.generator import from_image_space
from defensegan_torch.utils.misc import fold_seed, generator_for

LogitsFn = Callable[[torch.Tensor], torch.Tensor]
# z0_fn(x, key) -> z0 [B, R, k]: replaces the seeded restart draw
Z0Fn = Callable[[torch.Tensor, int], torch.Tensor]


def make_attack_target(gan, logits_fn: LogitsFn, cfg,
                       rec_iters: Optional[int] = None,
                       grad_mode: str = "exact",
                       z0_fn: Optional[Z0Fn] = None
                       ) -> Callable[[torch.Tensor, int], torch.Tensor]:
    """logits(x, key) through the defense, differentiable with respect to x.

    grad_mode="exact" (the reference's white-box): classifier(G(z*)) with
    z* from the R x L momentum-GD projection whose restarts are drawn from
    `key`, with back_prop=True so gradients flow to x through all L
    unrolled steps. grad_mode="bpda" (Athalye, Carlini & Wagner 2018,
    arXiv:1802.00420): the forward pass is the real projection, the
    backward pass the identity (x + stop_grad(G(z*) - x)). Both run the
    generator module itself (the generic path), as the JAX package's
    attack graphs do.

    cfg provides rec_rr / rec_lr / rec_momentum / latent_dim / rec_init
    (and rec_iters when not overridden); z0_fn replaces the seeded draw.
    """
    fwd = _defended_forward(gan, cfg, rec_iters, grad_mode, z0_fn)

    def attack_target(x: torch.Tensor, key: int) -> torch.Tensor:
        x_hat, _ = fwd(x, key)
        return logits_fn(x_hat)

    return attack_target


def _defended_forward(gan, cfg, rec_iters, grad_mode,
                      z0_fn: Optional[Z0Fn] = None):
    """(x, key) -> (x_hat, ReconstructionResult) through the defense.

    x_hat is differentiable with respect to x per grad_mode. With
    cfg.rec_init an encoder policy, z0 = encoder_z0(E, x, ...) is
    differentiable in x through the encoder, so exact gradients flow
    through both the encoder and the unrolled projection."""
    if grad_mode not in ("exact", "bpda"):
        raise ValueError(f"grad_mode must be 'exact' or 'bpda', "
                         f"got {grad_mode!r}")
    L = cfg.rec_iters if rec_iters is None else rec_iters
    rec_init = cfg.rec_init
    if rec_init != "random" and z0_fn is None and gan.encoder is None:
        raise RuntimeError(
            f"rec_init={rec_init!r} needs a trained encoder in the run's "
            f"weight export ({cfg.output_dir}/export)")

    def fwd(x: torch.Tensor, key: int):
        if z0_fn is not None:
            z0 = z0_fn(x, key)
        elif rec_init == "random":
            z0 = sample_z0(generator_for(key, x.device), x.shape[0],
                           cfg.rec_rr, cfg.latent_dim)
        else:
            z0 = encoder_z0(gan.encoder, x, generator_for(key, x.device),
                            rec_rr=cfg.rec_rr, mode=rec_init,
                            sigma=cfg.encoder_sigma)
        res = reconstruct(gan.generator, x, z0.to(x.device), rec_iters=L,
                          rec_lr=cfg.rec_lr, momentum=cfg.rec_momentum,
                          back_prop=(grad_mode == "exact"))
        x_hat = res.x_hat
        if grad_mode == "bpda":
            x_hat = x + (x_hat - x).detach()    # value G(z*), d/dx = I
        return x_hat, res

    return fwd


def make_attack_loss(gan, logits_fn: LogitsFn, cfg,
                     rec_iters: Optional[int] = None,
                     grad_mode: str = "exact", rec_penalty: float = 0.0,
                     rec_center: Optional[float] = None,
                     z0_fn: Optional[Z0Fn] = None
                     ) -> Callable[[torch.Tensor, torch.Tensor, int],
                                   torch.Tensor]:
    """Per-example attack loss through the defense, for PGD's loss_fn:

        loss(x, labels, key) = xent(classifier(G(z*)), labels)
                               - rec_penalty * penalty(rec_loss(x))   [B]

    rec_penalty > 0 is the detection-aware attack: rec_loss is the
    detector's statistic (the best restart's tanh-space MSE).
    rec_center=None penalizes rec_loss (the one-sided detector);
    rec_center=c penalizes (rec_loss - c)^2, steering the statistic to the
    clean median c (the two-sided detector's counter). In exact mode the
    penalty is differentiated through the unrolled projection; in bpda
    mode G(z*) is held constant, d rec / dx = 2 (x_tanh - G(z*)) / D.
    """
    fwd = _defended_forward(gan, cfg, rec_iters, grad_mode, z0_fn)

    def attack_loss(x: torch.Tensor, labels: torch.Tensor,
                    key: int) -> torch.Tensor:
        x_hat, res = fwd(x, key)
        loss = xent_per_example(logits_fn(x_hat), labels)
        if rec_penalty:
            if grad_mode == "exact":
                rec = res.loss
            else:
                t_hat = from_image_space(res.x_hat).detach()
                d = (from_image_space(x) - t_hat).to(torch.float32)
                rec = torch.mean(torch.square(d),
                                 dim=tuple(range(1, d.ndim)))
            pen = rec if rec_center is None else torch.square(rec
                                                              - rec_center)
            loss = loss - rec_penalty * pen
        return loss

    return attack_loss


def eot_over_keys(attack_target: Callable[[torch.Tensor, int],
                                          torch.Tensor],
                  k_eot: int) -> Callable[[torch.Tensor, int],
                                          torch.Tensor]:
    """EOT over projection keys: the mean defended logits over k_eot keys
    (fold_seed(key, j), j < k_eot), each a full differentiable projection;
    the counter-attack to K-pass vote serving (Athalye et al. 2018,
    arXiv:1707.07397, with the restart draw as the transformation). The
    k_eot projections run one after another."""
    if k_eot <= 1:
        return attack_target

    def eot_target(x: torch.Tensor, key: int) -> torch.Tensor:
        total = 0.0
        for j in range(k_eot):
            total = total + attack_target(x, fold_seed(key, j))
        return total / k_eot

    return eot_target


def attack_batch_key(k_att: int, lo: int) -> int:
    """Seed handed to the attack for the batch starting at offset lo."""
    return fold_seed(k_att, lo)


def split_rand_fgsm_key(k: int) -> Tuple[int, int]:
    """rand_fgsm takes two seeds per batch: (z0-restart seed, noise seed).
    The split lives here so that crafting and the replay leg agree."""
    return fold_seed(k, 0), fold_seed(k, 1)


def attack_z0_key(k_att: int, lo: int, attack_type: str) -> int:
    """The restart seed the attack graph used for batch offset lo (the
    --eval_z0 both replay leg draws its z0 from it)."""
    k = attack_batch_key(k_att, lo)
    if attack_type == "rand_fgsm":
        k, _ = split_rand_fgsm_key(k)
    return k
