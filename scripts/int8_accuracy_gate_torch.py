#!/usr/bin/env python3
"""The accuracy-level int8 gate of the PyTorch/CUDA port on the trained
flagship: clean- and FGSM(0.1)-defended accuracy through xla, pallas (v2)
and pallas_int8 (v2i) (defensegan_torch/cli/int8_accuracy_gate.py).

    python scripts/int8_accuracy_gate_torch.py                  # on the card
    python scripts/int8_accuracy_gate_torch.py --device cpu --cfg RUN_DIR
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from defensegan_torch.cli.int8_accuracy_gate import main  # noqa: E402

if __name__ == "__main__":
    main()
