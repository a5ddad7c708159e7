#!/usr/bin/env python
"""White-box attack + Defense-GAN evaluation on the PyTorch/CUDA port.

    python whitebox_torch.py --cfg output/gans/mnist_fast \
        --attack_type fgsm --defense_type defense_gan --model A

Runs on the card by default (--device cpu runs on the CPU); results go to
output/results_torch/whitebox.jsonl, classifiers are cached under
output/classifiers_torch/. See defensegan_torch/cli/whitebox.py for the
flags.
"""

from defensegan_torch.cli.whitebox import main

if __name__ == "__main__":
    main()
