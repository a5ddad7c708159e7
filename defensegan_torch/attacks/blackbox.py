"""Black-box attack pipeline: Jacobian-augmentation substitute training
(port of the JAX package's attacks/blackbox.py).

Reference parity: blackbox.py of kabkabm/defensegan, after the cleverhans
mnist_blackbox tutorial (Papernot et al., "Practical Black-Box Attacks",
arXiv:1602.02697):

  - the adversary holds a small seed set (150 test images in the paper);
  - each of `data_aug` rounds rho labels the current set by QUERYING the
    black-box target (the oracle), trains the substitute on those labels,
    then doubles the set by Jacobian augmentation
        x' = clip(x + lmbda_rho * sign(d Z_sub(x)[oracle label] / dx), 0, 1)
    with lmbda_rho = lmbda * (2 [rho // 3 != 0] - 1) (the tutorial's
    periodic sign rule);
  - FGSM crafted on the substitute transfers to the target.

The oracle's queries, the substitute's training and the augmentation
gradient run on the modules' device; the set itself grows on the host, as
a numpy array, so that the capped growth draws the same subset as the JAX
package (np.random.RandomState(rho)), index for index.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn as nn

from defensegan_torch.attacks.fgsm import input_grad
from defensegan_torch.eval.classifier import ClassifierState, train_classifier
from defensegan_torch.utils.misc import fold_seed

LogitsFn = Callable[[torch.Tensor], torch.Tensor]


def jacobian_augmentation(sub_logits_fn: LogitsFn, x: torch.Tensor,
                          oracle_labels: torch.Tensor,
                          lmbda: float) -> torch.Tensor:
    """x' = clip(x + lmbda * sign(d sum_i Z(x_i)[label_i] / dx), 0, 1)
    (reference: cleverhans jacobian_graph / jacobian_augmentation)."""
    labels = oracle_labels.long()[:, None]
    g = input_grad(lambda xx: torch.gather(sub_logits_fn(xx), 1,
                                           labels).sum(), x)
    return torch.clamp(x.detach() + lmbda * torch.sign(g), 0.0, 1.0)


def train_substitute(make_sub: Callable[[int], nn.Module],
                     oracle_fn: LogitsFn, x_seed: np.ndarray, *, seed: int,
                     data_aug: int = 6, lmbda: float = 0.1,
                     epochs_per_round: int = 10, batch_size: int = 128,
                     learning_rate: float = 1e-3, max_set_size: int = 12800,
                     persistent: bool = True, quiet: bool = True
                     ) -> Tuple[ClassifierState, np.ndarray]:
    """The train_sub loop of blackbox.py: rho rounds of oracle-label, train,
    Jacobian-augment. Returns (the substitute, the final set).

    make_sub(init_seed) -> a freshly initialized substitute on the device.
    persistent=True (the reference / cleverhans train_sub) builds it once
    and trains the SAME module on every round, from its current weights
    with a fresh Adam state; persistent=False re-initializes it every
    round from the round's seed (the --sub_from_scratch ablation). Round
    rho trains with seed fold_seed(seed, rho, 1) and initializes with
    fold_seed(seed, rho, 0), so round 0 is the same in both modes.
    """
    device = None
    x_sub = np.asarray(x_seed, np.float32)
    model = state = None
    for rho in range(data_aug):
        if model is None or not persistent:
            model = make_sub(fold_seed(seed, rho, 0))
            device = next(model.parameters()).device
        with torch.no_grad():
            y_sub = torch.argmax(oracle_fn(torch.as_tensor(x_sub)),
                                 dim=-1).cpu().numpy()
        state = train_classifier(model, x_sub, y_sub,
                                 seed=fold_seed(seed, rho, 1),
                                 epochs=epochs_per_round,
                                 batch_size=batch_size,
                                 learning_rate=learning_rate, quiet=quiet)
        model = state.model
        if rho == data_aug - 1:
            break
        if x_sub.shape[0] >= max_set_size:
            continue  # cap reached: keep refining on oracle labels only
        if 2 * x_sub.shape[0] > max_set_size:
            # cleverhans caps the growth by augmenting a random subset
            sel = np.random.RandomState(rho).choice(
                x_sub.shape[0], max_set_size - x_sub.shape[0], replace=False)
            base, base_y = x_sub[sel], y_sub[sel]
        else:
            base, base_y = x_sub, y_sub
        lmbda_rho = lmbda * (2 * int(int(rho / 3) != 0) - 1)
        x_new = jacobian_augmentation(
            state.logits_fn(), torch.as_tensor(base, device=device),
            torch.as_tensor(base_y, device=device), lmbda_rho)
        x_sub = np.concatenate([x_sub, x_new.cpu().numpy()], axis=0)
        if not quiet:
            print(f"  substitute round {rho + 1}/{data_aug}: "
                  f"set size {x_sub.shape[0]}")
    return state, x_sub
