#!/usr/bin/env python3
"""The stream64 probe of the PyTorch/CUDA port: one fused deconv level of
the 64x64 generator against cuDNN (defensegan_torch/experiments/
stream64_probe.py; every flag of scripts/stream64_probe.py, and --device).

    python scripts/stream64_probe_torch.py              # on the card
    python scripts/stream64_probe_torch.py --device cpu --batch 8 \
        --tile 4 --iters 2 --repeats 1                  # the plain version

Rows go to <results_dir>/stream64_probe.jsonl (output/results_torch).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from defensegan_torch.experiments.stream64_probe import main  # noqa: E402

if __name__ == "__main__":
    main()
