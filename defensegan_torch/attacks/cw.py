"""Carlini-Wagner L2 (port of the JAX package's attacks/cw.py).

Reference parity: cleverhans v2.x CarliniWagnerL2 as used by whitebox.py of
kabkabm/defensegan (--attack_type cw), after Carlini & Wagner
(arXiv:1608.04644):

  - change of variables x' = (tanh(w) + 1) / 2 scaled to [clip_min,
    clip_max], w = arctanh-image + modifier, so the box is implicit;
  - objective ||x' - x||_2^2 + c * f(x'), with the untargeted hinge
    f(x') = max(Z_y - max_{i != y} Z_i + confidence, 0);
  - Adam on the modifier (optax.adam's update, written out here),
    max_iterations inner steps;
  - an outer binary search over c with per-example bounds, keeping the
    successful adversary of least L2.

`carlini_wagner_l2` runs every inner step; `make_chunked_cw` runs the same
math in chunks and can stop a binary-search step early (cleverhans'
abort_early), checked at chunk boundaries.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

LogitsFn = Callable[..., torch.Tensor]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8     # optax.adam defaults


class CWConfig(NamedTuple):
    binary_search_steps: int = 5
    max_iterations: int = 1000
    learning_rate: float = 5e-3
    initial_const: float = 1e-2
    confidence: float = 0.0
    clip_min: float = 0.0
    clip_max: float = 1.0


def _to_tanh_space(x, cfg: CWConfig):
    x01 = (x - cfg.clip_min) / (cfg.clip_max - cfg.clip_min)
    x01 = torch.clamp(x01, 1e-6, 1.0 - 1e-6)
    return torch.atanh(x01 * 2.0 - 1.0)


def _from_tanh_space(w, cfg: CWConfig):
    x01 = (torch.tanh(w) + 1.0) * 0.5
    return x01 * (cfg.clip_max - cfg.clip_min) + cfg.clip_min


def _bcast(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (ndim - 1))


def _cw_machinery(logits_fn: LogitsFn, cfg: CWConfig, targeted: bool,
                  keyed: bool = False):
    """Shared pieces of the one-shot and the chunked attack.

    keyed=True: logits_fn takes (x, key) (a stochastic target: the
    classifier through the random-restart projection).

    Returns (step, inner_init, bs_init, bs_update):
      step(inner, c, x, w0, labels, key) -> (inner, objective): one Adam
        step at constants c [B]; objective = sum_b(l2_b + c_b hinge_b) at
        the step's starting point, the scalar abort_early watches
      inner_init(x, w0)                     fresh inner state
      bs_init(x)                            binary-search carry
      bs_update(bs_carry, l2, adv, found)   bounds + global-best update
    """

    def margins(logits, y_onehot):
        z_lab = torch.sum(logits * y_onehot, dim=-1)
        z_other = torch.max(logits - y_onehot * 1e9, dim=-1).values
        return z_lab, z_other

    def attack_succeeds(logits, y_onehot):
        z_lab, z_other = margins(logits, y_onehot)
        if targeted:
            return z_lab - z_other > cfg.confidence
        return z_other - z_lab > cfg.confidence

    def hinge(logits, y_onehot):
        z_lab, z_other = margins(logits, y_onehot)
        if targeted:
            return torch.clamp(z_other - z_lab + cfg.confidence, min=0.0)
        return torch.clamp(z_lab - z_other + cfg.confidence, min=0.0)

    def step(inner, c, x, w0, labels, key=None):
        modifier, mu, nu, count, best_l2, best_adv, found = inner
        sum_axes = tuple(range(1, x.ndim))
        mod = modifier.detach().requires_grad_(True)
        with torch.enable_grad():
            x_adv = _from_tanh_space(w0 + mod, cfg)
            logits = logits_fn(x_adv, key) if keyed else logits_fn(x_adv)
            y_onehot = F.one_hot(labels.long(), logits.shape[-1]).to(
                logits.dtype)
            l2 = torch.sum(torch.square(x_adv - x), dim=sum_axes)
            h = hinge(logits, y_onehot)
            (g,) = torch.autograd.grad(torch.sum(l2 + c * h), mod)
        x_adv, logits, l2, h = (x_adv.detach(), logits.detach(),
                                l2.detach(), h.detach())
        ok = attack_succeeds(logits, y_onehot)
        better = ok & (l2 < best_l2)
        best_l2 = torch.where(better, l2, best_l2)
        best_adv = torch.where(_bcast(better, x.ndim), x_adv, best_adv)
        found = found | ok
        count = count + 1
        mu = _B1 * mu + (1 - _B1) * g
        nu = _B2 * nu + (1 - _B2) * g * g
        mu_hat = mu / (1 - _B1 ** count)
        nu_hat = nu / (1 - _B2 ** count)
        modifier = modifier - cfg.learning_rate * mu_hat / (
            torch.sqrt(nu_hat) + _EPS)
        objective = torch.sum(l2 + c * h)
        return (modifier, mu, nu, count, best_l2, best_adv, found), \
            objective

    def inner_init(x, w0):
        batch = x.shape[0]
        z = torch.zeros_like(w0)
        return (z, torch.zeros_like(w0), torch.zeros_like(w0), 0,
                torch.full((batch,), float("inf"), device=x.device), x,
                torch.zeros((batch,), dtype=torch.bool, device=x.device))

    def bs_init(x):
        batch, dev = x.shape[0], x.device
        return (torch.full((batch,), cfg.initial_const, device=dev),
                torch.zeros((batch,), device=dev),
                torch.full((batch,), float("inf"), device=dev),
                torch.full((batch,), float("inf"), device=dev), x)

    def bs_update(carry, l2, adv, found):
        c, lower, upper, global_l2, global_adv = carry
        better = found & (l2 < global_l2)
        global_l2 = torch.where(better, l2, global_l2)
        global_adv = torch.where(_bcast(better, adv.ndim), adv, global_adv)
        upper = torch.where(found, torch.minimum(upper, c), upper)
        lower = torch.where(found, lower, torch.maximum(lower, c))
        has_upper = torch.isfinite(upper)
        c = torch.where(found, (lower + upper) / 2.0,
                        torch.where(has_upper, (lower + upper) / 2.0,
                                    c * 10.0))
        return (c, lower, upper, global_l2, global_adv)

    return step, inner_init, bs_init, bs_update


def carlini_wagner_l2(logits_fn: LogitsFn, x: torch.Tensor,
                      labels: torch.Tensor, cfg: CWConfig = CWConfig(),
                      targeted: bool = False,
                      key: Optional[int] = None) -> torch.Tensor:
    """CW-L2: adversarial examples (x where none was found).

    labels: true labels (untargeted, the paper's setting) or targets.
    key: when given, logits_fn is keyed, fn(x, key).
    """
    return make_chunked_cw(logits_fn, cfg, targeted=targeted,
                           chunk_iters=cfg.max_iterations,
                           keyed_logits=key is not None)(x, labels, key)


def effective_cw_chunk(cfg: CWConfig, chunk_iters: int,
                       abort_early: bool) -> int:
    """The chunk size make_chunked_cw runs (capped at abort_early's check
    cadence, max_iterations // 10, so the check can fire)."""
    chunk = max(1, min(chunk_iters, cfg.max_iterations))
    if abort_early:
        chunk = min(chunk, max(1, cfg.max_iterations // 10))
    return chunk


def make_chunked_cw(logits_fn: LogitsFn, cfg: CWConfig = CWConfig(),
                    targeted: bool = False, chunk_iters: int = 100,
                    abort_early: bool = False, verbose: bool = False,
                    keyed_logits: bool = False):
    """Build attack(x, labels, key=None) -> adv: carlini_wagner_l2's math
    in chunks of chunk_iters inner steps.

    abort_early (cleverhans CarliniWagnerL2's, default there True): stop a
    binary-search step once the objective fails to improve to 0.9999x its
    value at the previous check; checks come every max_iterations // 10
    steps, at chunk boundaries (the chunk is capped at that cadence).
    Off by default, which makes it carlini_wagner_l2 exactly.
    """
    chunk = effective_cw_chunk(cfg, chunk_iters, abort_early)
    check_every = max(chunk, cfg.max_iterations // 10 or 1)
    step, inner_init, bs_init, bs_update = _cw_machinery(
        logits_fn, cfg, targeted, keyed=keyed_logits)

    def attack(x: torch.Tensor, labels: torch.Tensor,
               key: Optional[int] = None) -> torch.Tensor:
        if keyed_logits and key is None:
            raise ValueError("keyed_logits=True: attack(x, labels, key) "
                             "needs a key")
        x = x.detach()
        w0 = _to_tanh_space(x, cfg)
        carry = bs_init(x)
        for b in range(cfg.binary_search_steps):
            c = carry[0]
            inner = inner_init(x, w0)
            done = 0
            prev_obj = float("inf")
            next_check = check_every
            while done < cfg.max_iterations:
                n = min(chunk, cfg.max_iterations - done)
                for _ in range(n):
                    inner, obj = step(inner, c, x, w0, labels, key)
                obj = float(obj)
                done += n
                if verbose:
                    print(f"  cw bs {b + 1}/{cfg.binary_search_steps} "
                          f"iter {done}/{cfg.max_iterations} (found "
                          f"{int(inner[6].sum())}/{x.shape[0]}, obj "
                          f"{obj:.4f})", flush=True)
                if abort_early and done >= next_check:
                    if obj > prev_obj * 0.9999:
                        if verbose:
                            print(f"  cw bs {b + 1}: abort_early at iter "
                                  f"{done} (objective plateaued)",
                                  flush=True)
                        break
                    prev_obj = obj
                    next_check += check_every
            _, _, _, _, l2, adv, found = inner
            carry = bs_update(carry, l2, adv, found)
        return carry[4]

    return attack


def carlini_wagner_l2_chunked(logits_fn: LogitsFn, x: torch.Tensor,
                              labels: torch.Tensor,
                              cfg: CWConfig = CWConfig(),
                              targeted: bool = False,
                              chunk_iters: int = 100,
                              abort_early: bool = False,
                              verbose: bool = False,
                              key: Optional[int] = None) -> torch.Tensor:
    """One-shot wrapper over `make_chunked_cw`."""
    return make_chunked_cw(logits_fn, cfg, targeted=targeted,
                           chunk_iters=chunk_iters,
                           abort_early=abort_early, verbose=verbose,
                           keyed_logits=key is not None)(x, labels, key)
