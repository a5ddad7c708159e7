#!/usr/bin/env python
"""North-star benchmark of the PyTorch/CUDA port: MNIST Defense-GAN
reconstructions/sec on one card (the port's counterpart of bench.py).

    python3 bench_torch.py                          # on the card
    python3 bench_torch.py --device cpu --deadline 0   # CPU, tests only

Measures the projection defense (R = 10 restarts x L = 200 momentum steps
on z, argmin-restart selection) through the port's DefenseGAN.reconstruct:
the flagship configs/gans/mnist_fast.yml (trained export under
output/gans/mnist_fast) at --batch images, cheap first xla -> pallas (v2)
-> pallas_int8 (v2i, only with a passing card stamp of the int8 gate,
export/int8_gate_cuda.json), then the deep mnist.yml on v3 at --deep_batch
(seeded weights unless its run has an export) as the deep_* fields.

Emission contract (as bench.py's; the last stdout line is the result):
  - This process, the SUPERVISOR, imports neither torch nor the port. It
    spawns one measurement WORKER (this file with --_worker, which runs
    defensegan_torch/cli/bench.py) and relays every record line the worker
    prints. It enforces --deadline (default 480 s, BENCH_DEADLINE_S) with
    SIGKILL, so a hung CUDA init or a slow cold nvcc build stalls only the
    worker, and whatever record was already relayed stands.
  - The worker prints a cumulative JSON record after every leg; every
    line but the last carries "partial": true.
  - If the worker dies before printing a record, the supervisor retries
    while the deadline leaves room, then prints a parseable diagnostic
    record (value 0.0, "error", and "last_progress": the worker's last
    stderr line, which names the stage it was in: the CUDA init, the
    kernels' build, a leg) and still exits 0.

Record: bench.py's keys, letter for letter ("metric", "value", "unit",
"vs_baseline", "gen_arch", "gen_dim", "kernel", "deep_value",
"deep_kernel", "deep_vs_baseline", "deep_unit"), plus "device". The
worker measures on CUDA unless --device says otherwise and raises
without a card; it never falls back to the CPU.

--trace <dir>: a torch.profiler Chrome trace of one more headline call.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# defensegan_torch/cli/bench.py::CFG_DIR; the supervisor imports nothing
# of the port
CFG_DIR = os.path.join(ROOT, "defensegan_torch", "configs", "gans")


# ----------------------------------------------------------- supervisor


def supervise(args, argv):
    """Spawn the worker, relay its record lines, enforce the deadline.

    The supervisor never imports torch: a hung CUDA init or a long cold
    nvcc build can only stall the WORKER, which gets SIGKILLed at the
    deadline; whatever record lines were already relayed stand (the last
    line is the result)."""
    deadline = time.monotonic() + args.deadline

    def remaining():
        return deadline - time.monotonic()

    last_record = None
    last_progress = [None]  # the worker's last stderr line: names the
    # stage a silent worker was stuck in (the CUDA init, the kernels' build)
    attempts = 0
    while attempts == 0 or remaining() > 5.0:
        attempts += 1
        budget = remaining()
        cmd = [sys.executable, os.path.abspath(__file__), "--_worker",
               "--deadline", f"{max(budget - 10.0, 5.0):.0f}"] + argv
        t0 = time.monotonic()
        # the worker leads a process group of its own, so that a kill
        # also ends the nvcc processes of a build it started
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                bufsize=1, start_new_session=True)

        def _kill():
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                proc.kill()

        def _watchdog():
            while proc.poll() is None:
                if deadline - time.monotonic() <= 0:
                    _kill()
                    return
                time.sleep(1.0)

        def _tee_stderr():
            for eline in proc.stderr:
                s = eline.rstrip()
                if s:
                    last_progress[0] = s
                print(eline, end="", file=sys.stderr)

        wd = threading.Thread(target=_watchdog, daemon=True)
        wd.start()
        tee = threading.Thread(target=_tee_stderr, daemon=True)
        tee.start()
        try:
            for line in proc.stdout:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    print(line, file=sys.stderr)
                    continue
                last_record = rec
                print(line, flush=True)
            rc = proc.wait()
        except BaseException:  # an interrupt of the supervisor ends the
            _kill()            # worker's group too, then propagates
            raise
        tee.join(timeout=2.0)  # drain the final stderr lines
        killed = rc in (-9, -15)
        if last_record is not None:
            return 0
        took = time.monotonic() - t0
        if killed:
            print(f"worker killed at deadline after {took:.0f}s with no "
                  "record", file=sys.stderr)
            break
        print(f"worker attempt {attempts} exited rc={rc} after {took:.0f}s "
              "with no record; "
              + (f"retrying ({remaining():.0f}s left)" if remaining() > 60
                 else "giving up"), file=sys.stderr)
        if remaining() > 60:
            time.sleep(min(30.0, max(0.0, remaining() - 60)))
        else:
            break
    if last_record is None:
        print(json.dumps({
            "metric": "mnist_reconstructions_per_sec_per_chip",
            "value": 0.0, "unit": "recon/s", "vs_baseline": 0.0,
            "error": (f"no measurement within the {args.deadline:.0f}s "
                      f"deadline ({attempts} worker attempts)"),
            "last_progress": last_progress[0],
        }), flush=True)
    return 0


def worker_argv(argv):
    """argv without --deadline: what the supervisor passes on to the
    worker (which gets its own --deadline)."""
    out = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--deadline":
            skip = True
            continue
        if a.startswith("--deadline="):
            continue
        out.append(a)
    return out


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--_worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--cfg", default=None,
                    help="config YAML or trained-run dir (default: the "
                    "shipped MNIST fast config, mnist_fast.yml)")
    ap.add_argument("--deep_cfg",
                    default=os.path.join(CFG_DIR, "mnist.yml"),
                    help="reference-faithful deep config measured alongside "
                    "the headline (emitted as deep_* fields); pass '' to "
                    "skip")
    ap.add_argument("--batch", type=int, default=16384,
                    help="headline images per call (bench.py's default)")
    ap.add_argument("--deep_batch", type=int, default=4096,
                    help="deep-leg images per call (bench.py's default)")
    ap.add_argument("--rec_rr", type=int, default=10)
    ap.add_argument("--rec_iters", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--kernel",
                    choices=["auto", "xla", "packed", "pallas",
                             "pallas_int8", "pallas_v4"],
                    default="auto",
                    help="auto = the cheap-first upgrade ladder (xla -> "
                    "pallas -> gated int8); an explicit kernel measures "
                    "only that headline leg")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a torch.profiler Chrome trace of one "
                    "headline call into DIR (chrome://tracing, Perfetto)")
    ap.add_argument("--deadline", type=float,
                    default=float(os.environ.get("BENCH_DEADLINE_S", 480)),
                    help="hard wall-clock budget (s): the supervisor kills "
                    "the measurement at this point and the best record "
                    "already printed stands (0 = no deadline, worker runs "
                    "in-process)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the legs run on (default cuda: the "
                    "card, raising without one; cpu for the tests)")
    return ap


def main():
    args, _ = build_parser().parse_known_args()
    if args._worker or args.deadline == 0:
        sys.path.insert(0, ROOT)
        from defensegan_torch.cli.bench import run_worker
        sys.exit(run_worker(args))
    sys.exit(supervise(args, worker_argv(sys.argv[1:])))


if __name__ == "__main__":
    main()
