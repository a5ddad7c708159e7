#!/usr/bin/env python3
"""DefendedPipeline latency and images/s per batch size on the PyTorch/CUDA
port (defensegan_torch/cli/serving_bench.py; every flag there).

    python scripts/serving_bench_torch.py --cfg output/gans/mnist_fast \
        --model A --batches 1 16 256 1024 4096 --repeats 3 [--sharded]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from defensegan_torch.cli.serving_bench import main  # noqa: E402

if __name__ == "__main__":
    main()
