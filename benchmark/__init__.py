"""The benchmark of the PyTorch and CUDA port, `defensegan_torch`, on one
NVIDIA H100: `python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` (cells, metrics and bounds in the
repository's BENCHMARK.json)."""
