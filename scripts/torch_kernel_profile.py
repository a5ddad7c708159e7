#!/usr/bin/env python3
"""Where a fused projection call spends its device time, per CUDA kernel.

Runs each hand-written loop of the PyTorch port (v2 bf16, v2i int8) once
at the smoke's main shape (1024 images x R 10 = 10240 rows; L steps,
default 20) on the flagship weights under torch.profiler, and prints one
JSON line per loop: the device time of each kernel (GEMM epilogue
variants, row quantization, casts) summed over the call, its share, and
the call's wall time under the profiler, and the median of 3 synchronized
calls outside it (call_ms). --chunks repeats this for each row-chunk size
of the wrappers (0: their default, one chunk up to the scratch cap). Needs
one CUDA device:

    python3 scripts/torch_kernel_profile.py [--iters 20] [--chunks 0,4096]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pack_width(pack) -> int:
    """The padded output width P the kernel runs over."""
    return getattr(pack, "base", pack).d.shape[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--chunks", default="0",
                    help="comma-separated rows per library call; 0 = the "
                         "wrapper's default")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    from defensegan_torch.configs import load_config
    from defensegan_torch.gan import DefenseGAN
    from defensegan_torch.kernels import (fused_projection_dense,
                                          fused_projection_dense_int8,
                                          pack_dense, pack_dense_int8)
    run_dir = os.path.join(ROOT, "output", "gans", "mnist_fast")
    gan = DefenseGAN(load_config(run_dir).replace(output_dir=run_dir)).load()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    n = 10240
    x = gan.generate(g, n).reshape(n, -1) * 2.0 - 1.0
    z0 = torch.randn(n, gan.cfg.latent_dim, device="cuda", generator=g)
    kw = dict(rec_iters=args.iters, rec_lr=gan.cfg.rec_lr,
              momentum=gan.cfg.rec_momentum)
    loops = [("fused_projection_v2", fused_projection_dense,
              pack_dense(gan.generator)),
             ("fused_projection_v2i", fused_projection_dense_int8,
              pack_dense_int8(gan.generator))]
    for (name, loop, pack), chunk in [
            (lp, int(c)) for lp in loops for c in args.chunks.split(",")]:
        def run():
            loop(pack, x, z0, **kw, **({"chunk": chunk} if chunk else {}))
            torch.cuda.synchronize()
        run()                                         # build + warm-up
        calls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            calls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall = time.perf_counter() - t0
        rows = []
        for e in prof.key_averages():
            dev_us = getattr(e, "device_time_total",
                             getattr(e, "cuda_time_total", 0.0))
            if dev_us > 0 and e.self_cpu_time_total == 0:
                rows.append((e.key, dev_us, e.count))
        total = sum(r[1] for r in rows)
        print(json.dumps({
            "loop": name, "rows": n, "iters": args.iters,
            "chunk": chunk or "default", "p": pack_width(pack),
            "call_ms": statistics.median(calls),
            "wall_ms": wall * 1e3, "device_ms": total / 1e3,
            "kernels": [{"kernel": k[:120], "ms": us / 1e3, "count": c,
                         "share": us / total if total else None}
                        for k, us, c in sorted(rows, key=lambda r: -r[1])]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
