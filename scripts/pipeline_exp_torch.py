#!/usr/bin/env python3
"""The DefendedPipeline's operator rows on the PyTorch/CUDA port: flag rate,
accuracy on unflagged inputs and undetected-success rate per adversarial
set (defensegan_torch/cli/pipeline_exp.py; every flag there).

    python scripts/pipeline_exp_torch.py --cfg output/gans/mnist_fast \
        --model A --detector combined \
        --sets output/advsets/flagship_conf_l300.npz
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from defensegan_torch.cli.pipeline_exp import main  # noqa: E402

if __name__ == "__main__":
    main()
