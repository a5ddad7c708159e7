#!/usr/bin/env python3
"""How often chip_smoke.py phase 11c's gate on the ten probe cases fails.

The gate: no case of experiments/v3_diag.py slower than its PyTorch
composition, as the median over the rounds of the kernel's host time
over the composition's, both writing into one given output (run_cases'
vs_library). This script runs v3_diag.run_cases `--runs` times with the
phase's rounds (chip_smoke.PROBE_REPEATS) and prints one JSON line: the
card and its power limit, and for each case the median ratio of every
run (`into`: the gate's; `alloc`: both calls allocating their output),
their smallest and largest, and the share of runs above 1. Exits 1 if any
case fails its check. Needs one CUDA device:

    python3 scripts/torch_probe_gate.py --runs 10
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_probe_gate: needs a CUDA device")
    import chip_smoke
    from defensegan_torch.experiments import v3_diag
    torch.backends.cuda.matmul.allow_tf32 = False
    ratios, ok, failed = {}, True, 0
    for _ in range(args.runs):
        recs = v3_diag.run_cases("cuda", repeats=chip_smoke.PROBE_REPEATS)
        ok = ok and all(r["ok"] for r in recs)
        failed += any(r["ok"] and r["vs_library"]["ratio"] > 1.0
                      for r in recs)
        for r in recs:
            runs = ratios.setdefault(r["case"], {"into": [], "alloc": []})
            if r["ok"]:
                runs["into"].append(r["vs_library"]["ratio"])
                runs["alloc"].append(r["vs_library_alloc"]["ratio"])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    cases = {case: {key: dict(runs=v, min=min(v), max=max(v),
                              above_1=sum(x > 1.0 for x in v) / len(v))
                    for key, v in runs.items() if v}
             for case, runs in ratios.items()}
    rec = {"card": smi.stdout.strip() or torch.cuda.get_device_name(0),
           "runs": args.runs, "rounds": chip_smoke.PROBE_REPEATS,
           "gate_failed_runs": failed,
           "cases": cases, "ok": ok}
    print(json.dumps(rec), flush=True)
    if not ok:
        raise SystemExit(1)
    return rec


if __name__ == "__main__":
    main()
