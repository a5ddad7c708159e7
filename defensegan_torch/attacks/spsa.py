"""SPSA: the gradient-free attack (Uesato et al. 2018, arXiv:1802.05666;
port of the JAX package's attacks/spsa.py).

Not in the reference repo. SPSA estimates the loss gradient from finite
differences of the forward pass only, so it attacks the defense as it is
deployed: the stochastic R-restart projection on its inference kernels
(the fused CUDA loops on the card), with no differentiable surrogate.

Semantics (untargeted, cleverhans SPSA lineage):
    p_0 = 0
    repeat nb_iter times, with v_k ~ Rademacher(x.shape), k = 1..n:
      ghat = mean_k [ (f(clip(x+p+delta*v_k)) - f(clip(x+p-delta*v_k)))
                      / (2*delta) * v_k ]
      p <- p + Adam(ghat)                      (ascend f)
      p <- clip(p, -eps, eps);  p <- clip(x+p, 0, 1) - x
with f a per-example loss to maximize, by default the margin
max_{i != y} z_i - z_y (> 0 iff misclassified).

Both probes of a pair are evaluated under the same defense seed (common
random numbers: the same restart z0 per position), so the difference
measures the perturbation, not restart luck; seeds are fresh per
(iteration, chunk). Each loss call evaluates one chunk of probe pairs as
one flat batch of chunk * B images, the large batches the projection
kernels are fastest on. The Rademacher draws come from a torch.Generator
on x's device, seeded per (iteration, chunk); `rademacher` replaces them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from defensegan_torch.attacks.compose import fold_seed, generator_for

# fold offsets separating the seed streams (Rademacher draws, defense
# seeds, the current-point eval); chunk indices stay far below them
_FOLD_RADEMACHER = 2 ** 20
_FOLD_DEFENSE = 2 ** 21
_FOLD_CURRENT = 2 ** 22

LossFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]
# rademacher(t, chunk_index, shape) -> +-1 tensor [s, *x.shape]
RademacherFn = Callable[[int, int, tuple], torch.Tensor]


def margin_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example untargeted objective: max_{i != y} z_i - z_y; positive
    iff the (defended) classifier is wrong."""
    idx = torch.arange(logits.shape[0], device=logits.device)
    labels = labels.long()
    true_logit = logits[idx, labels]
    masked = logits.clone()
    masked[idx, labels] = float("-inf")
    return torch.max(masked, dim=-1).values - true_logit


def confident_margin_loss(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """"Confidently wrong" objective: z_w - max_{j != w} z_j, with
    w = argmax_{i != y} z_i the best wrong class. Positive iff the
    classifier is wrong, and then equal to the two-feature detector's
    purified top1 - top2 margin."""
    idx = torch.arange(logits.shape[0], device=logits.device)
    masked = logits.clone()
    masked[idx, labels.long()] = float("-inf")
    z_w, w = torch.max(masked, dim=-1)
    rest = logits.clone()
    rest[idx, w] = float("-inf")
    return z_w - torch.max(rest, dim=-1).values


def make_spsa(loss_fn: LossFn, eps: float, nb_iter: int = 40,
              n_samples: int = 32, delta: float = 0.01, lr: float = 0.01,
              chunk_samples: int = 8, clip_min: float = 0.0,
              clip_max: float = 1.0, freeze_on_success: bool = True,
              verbose: bool = False):
    """Build an SPSA attacker: attack(x, labels, key, rademacher=None).

    loss_fn(x_flat [N, H, W, C], labels_flat [N], key) -> [N], the loss
    to maximize (a defended loss runs the real purification inside);
    probe batches arrive clipped to [clip_min, clip_max]. n_samples
    Rademacher pairs per estimate, chunk_samples pairs per loss call (when
    it does not divide n_samples, n_samples is rounded up, so every probe
    batch has one shape). freeze_on_success: examples whose current loss
    is > 0 keep their perturbation (the probes stay dense).
    """
    if n_samples < 1 or nb_iter < 1:
        raise ValueError("spsa needs n_samples >= 1 and nb_iter >= 1")
    chunk = max(1, min(chunk_samples, n_samples))
    if n_samples % chunk:
        rounded = ((n_samples + chunk - 1) // chunk) * chunk
        print(f"spsa: rounding n_samples {n_samples} up to {rounded} "
              f"(multiple of chunk_samples={chunk}; one probe-batch "
              "shape)", flush=True)
        n_samples = rounded
    b1, b2, eps_adam = 0.9, 0.999, 1e-7

    def draw(t, ci, kt, shape, device):
        gen = generator_for(fold_seed(kt, _FOLD_RADEMACHER + ci), device)
        return torch.randint(0, 2, shape, generator=gen,
                             device=device).to(torch.float32) * 2.0 - 1.0

    @torch.no_grad()
    def attack(x: torch.Tensor, labels: torch.Tensor, key: int,
               rademacher: Optional[RademacherFn] = None) -> torch.Tensor:
        if key is None:
            raise ValueError("spsa needs a key (Rademacher draws + "
                             "defense seeds)")
        bsz = x.shape[0]
        p = torch.zeros_like(x)
        m = torch.zeros_like(x)
        vv = torch.zeros_like(x)
        frozen = torch.zeros((bsz,), dtype=torch.bool, device=x.device)
        flat = (-1,) + tuple(x.shape[1:])
        for t in range(nb_iter):
            kt = fold_seed(key, t)
            cur = loss_fn(torch.clamp(x + p, clip_min, clip_max), labels,
                          fold_seed(kt, _FOLD_CURRENT))
            if freeze_on_success:
                frozen = cur > 0.0
            ghat = torch.zeros_like(x)
            done = ci = 0
            while done < n_samples:
                s = min(chunk, n_samples - done)
                shape = (s,) + tuple(x.shape)
                v = (rademacher(t, ci, shape) if rademacher is not None
                     else draw(t, ci, kt, shape, x.device)).to(x.dtype)
                base = x[None] + p[None]
                xp = torch.clamp(base + delta * v, clip_min, clip_max)
                xm = torch.clamp(base - delta * v, clip_min, clip_max)
                yrep = labels.repeat(s)
                kd = fold_seed(kt, _FOLD_DEFENSE + ci)
                lp = loss_fn(xp.reshape(flat), yrep, kd).reshape(s, bsz)
                lm = loss_fn(xm.reshape(flat), yrep, kd).reshape(s, bsz)
                d = (lp - lm) / (2.0 * delta)
                g_chunk = torch.mean(
                    d.reshape(d.shape + (1,) * (v.ndim - 2)) * v, dim=0)
                ghat = ghat + (s / n_samples) * g_chunk
                done += s
                ci += 1
            g = -ghat                      # Adam minimizes; ascend the loss
            m = b1 * m + (1 - b1) * g
            vv = b2 * vv + (1 - b2) * g * g
            mhat = m / (1 - b1 ** (t + 1))
            vhat = vv / (1 - b2 ** (t + 1))
            p_new = p - lr * mhat / (torch.sqrt(vhat) + eps_adam)
            p_new = torch.clamp(p_new, -eps, eps)
            p_new = torch.clamp(x + p_new, clip_min, clip_max) - x
            p = torch.where(frozen.reshape((-1,) + (1,) * (p.ndim - 1)),
                            p, p_new)
            if verbose:
                print(f"  spsa iter {t + 1}/{nb_iter}: mean loss "
                      f"{float(torch.mean(cur)):+.4f}, success "
                      f"{float(torch.mean((cur > 0).float())):.3f}",
                      flush=True)
        return torch.clamp(x + p, clip_min, clip_max)

    return attack
