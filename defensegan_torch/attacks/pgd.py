"""Projected Gradient Descent (Madry et al., arXiv:1706.06083; port of the
JAX package's attacks/pgd.py).

Not in the reference repo: PGD is the attack BPDA exists to power
(Athalye, Carlini & Wagner, arXiv:1802.00420), with EOT over the
defense's restart draws when the defense is randomized.

Semantics (untargeted):
    x_0   = clip(x + U(-eps, eps))              (rand_init, Madry)
    x_t+1 = Pi_{||.-x||_inf <= eps} clip(x_t + eps_iter * sign(g_t))
with g_t the gradient of the mean cross-entropy through `logits_fn`.

keyed_logits=True: logits_fn takes (x, key) (the attack-through-defense
target of attacks/compose.py) and step i evaluates it at
fold_seed(key, i) (per_step_keys=True, fresh restart draws every step,
EOT-style) or at `key` for every step (per_step_keys=False, one defense
instance, which the --eval_z0 both leg can replay).

`pgd` and `make_chunked_pgd` share the step math; in PyTorch both are a
host loop (the JAX package fuses `pgd` into one program and splits the
chunked attack into device programs to stay under the TPU watchdog), and
the chunked attack reports its progress every chunk_iters steps.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from defensegan_torch.attacks.compose import fold_seed, generator_for
from defensegan_torch.attacks.fgsm import input_grad, xent_per_example

LogitsFn = Callable[..., torch.Tensor]

# fold index of the rand_init noise seed, far above any step index
_INIT_FOLD = 2 ** 31 - 1


def _pgd_machinery(logits_fn: LogitsFn, eps: float, eps_iter: float,
                   clip_min: float, clip_max: float, targeted: bool,
                   keyed: bool, per_step_keys: bool, loss_fn=None):
    """Shared step math.

    loss_fn (optional): per-example loss (x_adv, labels, key) -> [B] that
    replaces the cross-entropy through logits_fn (e.g. the detection-aware
    loss of attacks/compose.py::make_attack_loss); its mean is ascended.

    Returns (init, step):
      init(x, key, noise=None)          rand_init start; noise (x's shape,
                                        in [-eps, eps]) replaces the draw
      step(x_adv, i, x, labels, key)    one signed-gradient step at index i
    """
    if loss_fn is not None and not keyed:
        raise ValueError(
            "loss_fn requires keyed_logits=True (the custom loss is "
            "called as loss_fn(x_adv, labels, key)); pass keyed_logits="
            "True and a key — a deterministic loss_fn may ignore it")

    def loss(x_adv, labels, key):
        if loss_fn is not None:
            return torch.mean(loss_fn(x_adv, labels, key))
        logits = logits_fn(x_adv, key) if keyed else logits_fn(x_adv)
        return torch.mean(xent_per_example(logits, labels))

    def init(x, key, noise: Optional[torch.Tensor] = None):
        if noise is None:
            gen = generator_for(fold_seed(key, _INIT_FOLD), x.device)
            noise = (torch.rand(x.shape, generator=gen, device=x.device,
                                dtype=x.dtype) * 2.0 - 1.0) * eps
        return torch.clamp(x + noise, clip_min, clip_max)

    def step(x_adv, i, x, labels, key):
        k = None
        if keyed:
            k = fold_seed(key, i) if per_step_keys else key
        g = input_grad(lambda xx: loss(xx, labels, k), x_adv)
        direction = -torch.sign(g) if targeted else torch.sign(g)
        x_adv = x_adv.detach() + eps_iter * direction
        x_adv = torch.minimum(torch.maximum(x_adv, x - eps), x + eps)
        return torch.clamp(x_adv, clip_min, clip_max)

    return init, step


def pgd(logits_fn: LogitsFn, x: torch.Tensor, labels: torch.Tensor,
        eps: float, eps_iter: float, nb_iter: int,
        key: Optional[int] = None, clip_min: float = 0.0,
        clip_max: float = 1.0, targeted: bool = False,
        rand_init: bool = True, keyed_logits: bool = False,
        per_step_keys: bool = True, loss_fn=None,
        init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PGD. labels: true labels (untargeted) or targets (targeted=True).
    key (an integer seed) seeds the rand_init draw and the keyed target's
    steps; init_noise replaces the rand_init draw."""
    return make_chunked_pgd(logits_fn, eps, eps_iter, nb_iter,
                            targeted=targeted, rand_init=rand_init,
                            chunk_iters=nb_iter, clip_min=clip_min,
                            clip_max=clip_max, keyed_logits=keyed_logits,
                            per_step_keys=per_step_keys,
                            loss_fn=loss_fn)(x, labels, key, init_noise)


def make_chunked_pgd(logits_fn: LogitsFn, eps: float, eps_iter: float,
                     nb_iter: int, targeted: bool = False,
                     rand_init: bool = True, chunk_iters: int = 10,
                     clip_min: float = 0.0, clip_max: float = 1.0,
                     keyed_logits: bool = False,
                     per_step_keys: bool = True,
                     verbose: bool = False, loss_fn=None):
    """Build attack(x, labels, key=None, init_noise=None) -> x_adv: `pgd`'s
    math, reporting progress every chunk_iters steps (verbose)."""
    init, step = _pgd_machinery(logits_fn, eps, eps_iter, clip_min,
                                clip_max, targeted, keyed_logits,
                                per_step_keys, loss_fn=loss_fn)
    chunk = max(1, min(chunk_iters, nb_iter))

    def attack(x: torch.Tensor, labels: torch.Tensor,
               key: Optional[int] = None,
               init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if key is None and (keyed_logits
                            or (rand_init and init_noise is None)):
            raise ValueError("pgd needs a key when rand_init=True (without "
                             "init_noise) or keyed_logits=True")
        x = x.detach()
        x_adv = init(x, key, init_noise) if rand_init else x
        for i in range(nb_iter):
            x_adv = step(x_adv, i, x, labels, key)
            if verbose and ((i + 1) % chunk == 0 or i + 1 == nb_iter):
                print(f"  pgd iter {i + 1}/{nb_iter}", flush=True)
        return x_adv

    return attack
