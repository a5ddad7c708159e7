#!/usr/bin/env python3
"""The encoder-init frontier on the PyTorch/CUDA port: clean-defended and
FGSM-through-defense accuracy, detection AUCs and recon/s per (R, L) x init
cell, and the encoder's train leg (defensegan_torch/cli/encoder_exp.py;
every flag there).

    python scripts/encoder_exp_torch.py --cfg output/gans/mnist_fast \
        --model A --grid 10x200 2x50 1x25
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from defensegan_torch.cli.encoder_exp import main  # noqa: E402

if __name__ == "__main__":
    main()
