"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cells, metrics and bounds are in BENCHMARK.json at the root of the
checkout; the last line on standard output is one JSON object (correct,
attempted, failed, metrics, device[, breakdown], checked), and the last
lines on standard error are each compared number beside its limit. Exits
3 without a CUDA device (or with fewer than the cell asks for) and 4 when
JAX, flax or the JAX package was loaded, printing no result either way.
"""

import time

T_START = time.perf_counter()     # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness, spec
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = harness.run_cell(bench, cell, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0),
                           T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark runs the PyTorch "
              "port alone", file=sys.stderr)
        return 4
    sys.stdout.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
