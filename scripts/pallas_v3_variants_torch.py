#!/usr/bin/env python3
"""The A/B of the deep loop's layout experiments (v3p, tap-packed conv A,
two-chain ILP) against v3 in the PyTorch/CUDA port (defensegan_torch/
experiments/v3_variants.py): the gate against v3, then recon/s of both.

    python scripts/pallas_v3_variants_torch.py --variant v3p packed ilp
    python scripts/pallas_v3_variants_torch.py --variant ilp --batch 1024

Rows go to <results_dir>/pallas_v3_variants.jsonl (output/results_torch).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from defensegan_torch.experiments.v3_variants import main  # noqa: E402

if __name__ == "__main__":
    main()
