"""Classifier training (cross-entropy + Adam) and the classifier cache
(port of the JAX package's eval/classifier.py).

Reference parity: cleverhans model_train as used by whitebox.py of
kabkabm/defensegan: Adam at 1e-3, batch 128, a fresh permutation of the
training set each epoch, floor(N / batch) steps an epoch. adv_eps turns on
the reference's adv_tr baseline: each batch also crafts FGSM at the
current weights and trains on 0.5 * clean + 0.5 * adversarial loss. The
permutations and the dropout masks come from torch.Generators seeded by
the caller (permutations on the CPU, masks on the model's device); the
clean and the adversarial forward of one step share their masks, as they
share the dropout key in the JAX package.

The cache lives under output/classifiers_torch/<tag>/ (torch checkpoints,
ckpt/checkpoint.py); the JAX package's output/classifiers/ is never read
or written.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from defensegan_torch.ckpt import (latest_step, restore_checkpoint,
                                   save_checkpoint)

CACHE_ROOT = os.path.join("output", "classifiers_torch")

LogitsFn = Callable[[torch.Tensor], torch.Tensor]


class ClassifierState(NamedTuple):
    model: nn.Module

    def logits_fn(self) -> LogitsFn:
        return make_logits_fn(self.model)


def make_logits_fn(model: nn.Module) -> LogitsFn:
    """Inference-mode logits (dropout off) of [0, 1] NHWC images; inputs
    move to the model's device, and stay differentiable for the attacks."""
    device = next(model.parameters()).device

    def logits_fn(x):
        return model(torch.as_tensor(x).to(device))

    return logits_fn


def cache_dir(tag: str) -> str:
    return os.path.join(CACHE_ROOT, tag)


def load_cached_classifier(tag: str, model: nn.Module
                           ) -> Optional[ClassifierState]:
    """Load the classifier cached under output/classifiers_torch/<tag> into
    `model` (on its device), or None when there is none."""
    d = cache_dir(tag)
    if latest_step(d) is None:
        return None
    device = next(model.parameters()).device
    model.load_state_dict(restore_checkpoint(d, map_location=device))
    return ClassifierState(model.requires_grad_(False))


def save_classifier(tag: str, state: ClassifierState) -> str:
    return save_checkpoint(cache_dir(tag), 0, state.model.state_dict())


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of logits against integer labels."""
    return F.cross_entropy(logits.to(torch.float32), labels.long())


def make_train_step(model: nn.Module, opt: torch.optim.Optimizer,
                    adv_eps: Optional[float] = None):
    """step(xb, yb, dropout) -> loss: one Adam step on a batch (on the
    model's device). dropout: a torch.Generator for the masks, or None for
    a step with dropout off."""

    def step(xb, yb, dropout: Optional[torch.Generator]):
        if adv_eps is not None:
            xg = xb.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(xent(model(xg), yb), xg)
            xb_adv = torch.clamp(xb + adv_eps * torch.sign(g), 0.0,
                                 1.0).detach()
        state = dropout.get_state() if dropout is not None else None
        loss = xent(model(xb, dropout), yb)
        if adv_eps is not None:
            if dropout is not None:
                dropout.set_state(state)          # the clean step's masks
            loss = 0.5 * loss + 0.5 * xent(model(xb_adv, dropout), yb)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def train_classifier(model: nn.Module, x: np.ndarray, y: np.ndarray, *,
                     seed: int, epochs: int = 10, batch_size: int = 128,
                     learning_rate: float = 1e-3,
                     adv_eps: Optional[float] = None,
                     quiet: bool = True) -> ClassifierState:
    """Train `model` (on its device) on x [N, H, W, C] in [0, 1], y [N].

    Training starts from the module's current weights with a fresh Adam
    state, so passing the module a previous call returned (`state.model`)
    trains it on: the JAX package's `params=` warm start, which the
    persistent black-box substitute uses every round. A fresh init is a
    freshly built module (build_classifier with a seeded generator). seed
    seeds the permutation generator (CPU) and the dropout generator (the
    model's device). Returns the trained model, frozen.
    """
    device = next(model.parameters()).device
    with torch.no_grad():
        n_out = int(model(torch.zeros((1,) + tuple(x.shape[1:]),
                                      device=device)).shape[-1])
    y_arr = np.asarray(y)
    if y_arr.size and (int(y_arr.min()) < 0 or int(y_arr.max()) >= n_out):
        raise ValueError(
            f"labels out of range for a {n_out}-way classifier: "
            f"min={int(y_arr.min())} max={int(y_arr.max())}")
    model.requires_grad_(True)
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate, eps=1e-8)
    step = make_train_step(model, opt, adv_eps)
    perm_gen = torch.Generator().manual_seed(seed)
    drop_gen = torch.Generator(device=device).manual_seed(seed + 1)
    xd = torch.as_tensor(np.asarray(x, np.float32), device=device)
    yd = torch.as_tensor(y_arr.astype(np.int64), device=device)
    n = xd.shape[0]
    steps_per_epoch = max(n // batch_size, 1)
    loss = torch.zeros(())
    for epoch in range(epochs):
        perm = torch.randperm(n, generator=perm_gen).to(device)
        for i in range(steps_per_epoch):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            loss = step(xd[idx], yd[idx], drop_gen)
        if not quiet:
            print(f"  classifier epoch {epoch + 1}/{epochs} "
                  f"loss={float(loss):.4f}")
    return ClassifierState(model.requires_grad_(False))
