#!/usr/bin/env python3
"""The ten construct probes of the v3 kernel in the PyTorch/CUDA port
(defensegan_torch/experiments/v3_diag.py): each case of
scripts/pallas_v3_diag.py at its shapes, through its hand-written kernel,
held against its plain version and timed; one `PASS <case>: sum=...` line
a case (its ms and error beside), `FAIL <case>: ...` and exit 1 if any
case raises or leaves its bound.

    python scripts/pallas_v3_diag_torch.py                  # on the card
    python scripts/pallas_v3_diag_torch.py --device cpu     # plain versions
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from defensegan_torch.experiments.v3_diag import main  # noqa: E402

if __name__ == "__main__":
    main()
