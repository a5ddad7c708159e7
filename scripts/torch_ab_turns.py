#!/usr/bin/env python3
"""Two checkouts of the port timed in turns on one card: the parent and
the change of a PR, in the order parent, change, change, parent, so that
drift of the card or its host over the call shows as the difference of
the two parent turns.

Each turn runs, from the repository's own scripts with `--root` on the
turn's checkout (each a process of its own):

  * scripts/torch_v3_zfinal.py for v3, v3p and packed at 10240 rows x
    L 200 (1024 images x R 10): the loop's median ms of 3 and the sha256
    of z_final;
  * scripts/torch_kernel_profile.py --kernel stream64 (each level's
    launches, device ms), --kernel v4 and --kernel ilp (call_ms, L 20);
  * the checkout's own scripts/pallas_v3_diag2_torch.py (each cut's host
    ms on a plan).

    python3 scripts/torch_ab_turns.py --parent build/chip/parent \\
        [--change .] [--only packed v3 ...]

Prints one JSON line per turn and measurement, then one summary line: per
measurement, each turn's number and the change's mean over the parent's.
Needs one CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
MEASURES = ("v3", "v3p", "packed", "stream64", "v4", "ilp", "v3_diag2")


def _json_lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def measure(what: str, root: str) -> dict:
    """One measurement on one checkout: {"value": ms, ...}."""
    py = sys.executable
    if what in ("v3", "v3p", "packed"):
        cmd = [py, os.path.join(SCRIPTS, "torch_v3_zfinal.py"), "--root",
               root, "--variant", what, "--rows", "10240", "--iters", "200"]
    elif what == "v3_diag2":
        cmd = [py, os.path.join(root, "scripts", "pallas_v3_diag2_torch.py")]
    else:
        cmd = [py, os.path.join(SCRIPTS, "torch_kernel_profile.py"),
               "--root", root, "--kernel", what, "--iters", "20"]
    run = subprocess.run(cmd, capture_output=True, text=True, check=True)
    if what in ("v3", "v3p", "packed"):
        rec = _json_lines(run.stdout)[-1]
        return {"value": rec["ms"], "sha256": rec["sha256"],
                "ms_all": rec["ms_all"]}
    if what == "v3_diag2":
        cuts = {}
        for line in run.stdout.splitlines():
            if line.startswith("PASS upto="):
                name = line.split("=", 1)[1].split(":", 1)[0]
                cuts[name] = float(line.split(" ms=", 1)[1].split()[0])
        return {"value": cuts["full"], "cuts_ms": cuts}
    if what == "stream64":
        levels = [r["stream64"] for r in _json_lines(run.stdout)
                  if "stream64" in r and r["stream64"]["config"] in
                  ("skip", "all")]
        # the checkout's own kernel: the skip where it has one
        own = [r for r in levels if r["config"] == "skip"] or levels
        return {"value": sum(r["ms"] for r in own),
                "levels": {f"L{r['level']} {r['config']}": r["ms"]
                           for r in levels}}
    rec = [r for r in _json_lines(run.stdout) if "loop" in r][-1]
    return {"value": rec["call_ms"], "device_ms": rec["device_ms"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--change", default=ROOT)
    ap.add_argument("--only", nargs="+", choices=MEASURES, default=MEASURES)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    turns = [("parent", args.parent), ("change", args.change),
             ("change", args.change), ("parent", args.parent)]
    got = {what: {"parent": [], "change": []} for what in args.only}
    for i, (side, root) in enumerate(turns):
        for what in args.only:
            rec = measure(what, os.path.abspath(root))
            got[what][side].append(rec["value"])
            print(json.dumps({"turn": i, "side": side, "what": what, **rec}),
                  flush=True)
    summary = {what: {**v, "change_over_parent": statistics.mean(
        v["change"]) / statistics.mean(v["parent"])}
        for what, v in got.items()}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
