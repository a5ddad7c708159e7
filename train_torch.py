#!/usr/bin/env python
"""WGAN-GP training and test mode on the PyTorch/CUDA port.

    python train_torch.py --cfg defensegan_torch/configs/gans/mnist_fast.yml \
        --is_train --output_dir output/gans_torch/mnist_fast
    python train_torch.py --cfg output/gans_torch/mnist_fast      # test mode
    python train_torch.py --cfg output/gans_torch/mnist_fast --train_encoder

Runs on the card by default (--device cpu runs on the CPU). A run writes
cfg.yml, metrics.jsonl, samples/, checkpoints/<step>.pt (resumed from) and
export/<step>.npz (the weights whitebox_torch.py and blackbox_torch.py
load) under its output directory. See defensegan_torch/cli/train.py for
the flags.
"""

from defensegan_torch.cli.train import main

if __name__ == "__main__":
    main()
