#!/usr/bin/env python3
"""The int8 gate of the PyTorch/CUDA port on the trained flagship and v2 /
v2i throughput (defensegan_torch/cli/int8_validate.py; every flag there).

    python scripts/int8_validate_torch.py                 # on the card
    python scripts/int8_validate_torch.py --out /tmp/gate.json
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from defensegan_torch.cli.int8_validate import main  # noqa: E402

if __name__ == "__main__":
    main()
