"""Adversarial attacks in PyTorch (port of the JAX package's attacks/).

FGSM, RAND+FGSM and CW-L2 (the reference's cleverhans suite), PGD with
BPDA / EOT (Madry et al.; Athalye et al. 2018) and the gradient-free SPSA
(Uesato et al. 2018). Every attack takes a `logits_fn(x) -> logits`
closure; composing it with the defense's differentiable reconstruction
(attacks/compose.py, back_prop=True) gives the paper's white-box attack
through the defense. The black-box pipeline (blackbox.py) trains a
substitute by Jacobian augmentation against the target's labels and
transfers FGSM from it. They are plain PyTorch, as the JAX package leaves
them to XLA: no kernel of their own.
"""

from defensegan_torch.attacks.compose import (attack_batch_key,
                                              attack_z0_key, eot_over_keys,
                                              fold_seed, make_attack_loss,
                                              make_attack_target,
                                              split_rand_fgsm_key)
from defensegan_torch.attacks.blackbox import (jacobian_augmentation,
                                               train_substitute)
from defensegan_torch.attacks.cw import (CWConfig, carlini_wagner_l2,
                                         carlini_wagner_l2_chunked,
                                         effective_cw_chunk,
                                         make_chunked_cw)
from defensegan_torch.attacks.fgsm import fgsm, rand_fgsm
from defensegan_torch.attacks.pgd import make_chunked_pgd, pgd
from defensegan_torch.attacks.spsa import (confident_margin_loss,
                                           make_spsa, margin_loss)

__all__ = [
    "attack_batch_key", "attack_z0_key", "eot_over_keys", "fold_seed",
    "make_attack_loss", "make_attack_target", "split_rand_fgsm_key",
    "CWConfig", "carlini_wagner_l2", "carlini_wagner_l2_chunked",
    "effective_cw_chunk", "make_chunked_cw", "fgsm", "rand_fgsm",
    "make_chunked_pgd", "pgd", "confident_margin_loss", "make_spsa",
    "margin_loss", "jacobian_augmentation", "train_substitute",
]
