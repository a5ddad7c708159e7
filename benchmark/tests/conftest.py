"""The benchmark's own tests: `python3 -m pytest benchmark/tests -q` (CPU;
the card's tests are marked `cuda` and skip without a CUDA device:
`python3 -m pytest benchmark/tests -m cuda -q` on the card)."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100)")
    return torch.device("cuda", 0)
