#!/usr/bin/env python3
"""v3's step cut after each of its seven sections in the PyTorch/CUDA port
(defensegan_torch/experiments/v3_diag2.py): scripts/pallas_v3_diag2.py's
cuts (fc, convA, convB, grad, convB_bwd, convA_bwd, full) on mnist.yml
with seeded weights at 64 latents, L 1, through the hand-written kernel;
each cut's section held against the plain version's, z_out against z0
before `full`; one `PASS upto=<cut>: sum=...` line a cut (its ms and
error beside), `FAIL upto=<cut>: ...` and exit 1 if any cut fails.

    python scripts/pallas_v3_diag2_torch.py                 # on the card
    python scripts/pallas_v3_diag2_torch.py --device cpu    # plain version
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from defensegan_torch.experiments.v3_diag2 import main  # noqa: E402

if __name__ == "__main__":
    main()
