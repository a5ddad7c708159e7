#!/usr/bin/env python
"""Black-box (substitute transfer) attack + Defense-GAN evaluation on the
PyTorch/CUDA port.

    python blackbox_torch.py --cfg output/gans/mnist_fast \
        --bb_model A --sub_model B --defense_type defense_gan

Runs on the card by default (--device cpu runs on the CPU); results go to
output/results_torch/blackbox.jsonl. See defensegan_torch/cli/blackbox.py
for the flags.
"""

from defensegan_torch.cli.blackbox import main

if __name__ == "__main__":
    main()
