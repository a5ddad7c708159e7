#!/usr/bin/env python3
"""Where a fused projection call spends its device time, per CUDA kernel.

Runs each hand-written loop of the PyTorch port (v2 bf16 and v2i int8 on
the flagship weights; v3 on the deep mnist.yml generator and v4 on the
64x64 celeba.yml generator, both with the smoke's seeded weights) once at
the smoke's main shape (1024 images x R 10 = 10240 rows; v4: 512 images x
R 2 = 1024 rows; L steps, default 20) under torch.profiler, and prints one
JSON line per loop: the device time of each kernel (GEMM epilogue variants,
the 3x3 grid convs, row quantization, casts) summed over the call, its
share, and the call's wall time under the profiler, and the median of 3
synchronized calls outside it (call_ms). For v3 each kernel is also named
by the launch of the step it is (fc, conv A, conv B, their backwards). The
levels of v4 share their kernels, so its line adds `by_launch`: device time
by the position of a launch in the step (fc, each level forward, each level
backward, fc backward), from the order of the launches on the stream. Each
launch of v3 and v4 also carries the operations it issues (the padded
widths, skipped border taps left out) and its share of the bf16 peak
(989 TFLOP/s) on them;
--config runs v4 on another 64x64 config (celeba_wide, imagenet64) at the
same rows. --chunks repeats this for each row-chunk size of the wrappers
(0: their default, one chunk up to the scratch cap). Needs one CUDA device:

    python3 scripts/torch_kernel_profile.py [--kernel all|v2|v2i|v3|v4] \
        [--iters 20] [--chunks 0,4096] [--config celeba]
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


PEAK_BF16 = 989e12      # dense bf16 peak of one H100 SXM (data sheet)

# the launches of one v3 step, by a substring of the kernel's name (the
# grid conv's epilogues name its two directions)
V3_LAUNCHES = (("EpiConvBiasRelu", "conv A forward"),
               ("EpiConvReluMask", "conv A backward"),
               ("EpiStoreBf16", "conv B forward (packed product)"),
               ("tanh_grad_pack", "conv B tap sum + tanh gradient + pack"),
               ("EpiReluMask", "conv B backward"),
               ("EpiBiasRelu", "fc forward"),
               ("EpiMomentum", "fc backward + momentum"),
               ("cast_bf16", "z -> bf16"))


def pack_width(pack) -> int:
    """The padded output width P the kernel runs over (v2, v2i); for v3
    the s2d output width, for v4 the double-blocked one."""
    base = getattr(pack, "base", pack)
    if hasattr(base, "d"):
        return base.d.shape[1]
    if hasattr(base, "levels"):
        return base.final_g ** 2 * base.out_lanes
    return base.grid_hw ** 2 * base.cb


def launch_of(kernel_name: str):
    for needle, label in V3_LAUNCHES:
        if needle in kernel_name:
            return label
    return None


def v4_step_labels(pack):
    """The launches of one v4 step, in stream order."""
    lv = level_names(pack)
    return (["fc forward"] + [f"{name} forward" for name in lv]
            + [f"{name} backward" for name in reversed(lv)]
            + ["fc backward + momentum"])


def taps(g: int) -> int:
    """Valid taps of a 3x3 SAME conv on a g x g grid, over all pixels."""
    from defensegan_torch.kernels.fused_projection_v3 import _tap_masks
    return int(_tap_masks(g).sum())


def issued_flop(pack, rows: int, iters: int) -> dict:
    """Operations each launch of a v3 or v4 step issues over `iters` steps
    at the kernel's padded widths, by launch label."""
    from defensegan_torch.kernels.fused_projection_v3 import padded_s2d
    from defensegan_torch.kernels.fused_projection_v4 import padded_v4
    n = 2.0 * rows * iters
    if hasattr(pack, "levels"):
        pp = padded_v4(pack)
        fc = n * pp.z_dim * pp.base_hw ** 2 * pp.c0
        out = {"fc forward": fc, "fc backward + momentum": fc}
        for name, lv in zip(level_names(pack), pp.levels):
            conv = n * taps(lv.g) * lv.ci * lv.co
            out[f"{name} forward"] = out[f"{name} backward"] = conv
        return out
    pp = padded_s2d(pack)
    p2 = pp.grid_hw ** 2
    fc = n * pp.z_dim * p2 * pp.c0
    conv_a = n * taps(pp.grid_hw) * pp.c0 * pp.ca
    return {"fc forward": fc, "fc backward + momentum": fc,
            "conv A forward": conv_a, "conv A backward": conv_a,
            "conv B forward (packed product)":
                n * p2 * pp.ca * pp.kbp.shape[1],
            "conv B backward": n * p2 * pp.kbpt.shape[0] * pp.ca}


def peak_share(flop, ms):
    return None if not flop or not ms else flop / (ms * 1e-3) / PEAK_BF16


def level_names(pack):
    return [f"level {i} (g {l.g}, {l.ci} -> {l.co})"
            for i, l in enumerate(pack.levels)]


def by_launch(prof, labels, iters: int, flop: dict):
    """Device time by position in the step: the library's kernels (C++
    namespace fpk) in stream order are one cast, then `iters` steps of
    len(labels) launches."""
    from torch.autograd import DeviceType
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "fpk::" in e.name),
                 key=lambda e: e.time_range.start)
    if len(evs) != 1 + iters * len(labels):
        return {"error": f"{len(evs)} device kernels, expected "
                         f"{1 + iters * len(labels)}"}
    us = [0.0] * len(labels)
    for i, e in enumerate(evs[1:]):
        us[i % len(labels)] += e.time_range.elapsed_us()
    total = sum(us)
    return [{"launch": name, "ms": t / 1e3, "share": t / total,
             "issued_tflop": flop.get(name, 0.0) / 1e12,
             "bf16_peak_share": peak_share(flop.get(name), t / 1e3)}
            for name, t in zip(labels, us)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="all",
                    choices=("all", "v2", "v2i", "v3", "v4"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--config", default="celeba",
                    choices=("celeba", "celeba_wide", "imagenet64"),
                    help="the 64x64 config that v4 runs")
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

    from chip_smoke import seeded_celeba_gan, seeded_deep_gan
    from defensegan_torch.configs import load_config
    from defensegan_torch.defense.fastgen import pack_generator
    from defensegan_torch.gan import DefenseGAN
    from defensegan_torch.kernels import (fused_projection_dense,
                                          fused_projection_dense_int8,
                                          fused_projection_s2d, pack_dense,
                                          pack_dense_int8, pack_s2d, pack_v4)
    from defensegan_torch.kernels.fused_projection_v4 import (
        fused_projection_v4, x_rows)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    n = 10240                  # rows of the v2, v2i and v3 loops
    want = ("v2", "v2i", "v3", "v4") if args.kernel == "all" \
        else (args.kernel,)
    loops = []
    if "v2" in want or "v2i" in want:
        run_dir = os.path.join(ROOT, "output", "gans", "mnist_fast")
        gan = DefenseGAN(load_config(run_dir).replace(
            output_dir=run_dir)).load()
        x = gan.generate(g, n).reshape(n, -1) * 2.0 - 1.0
        for tag, loop, pack_fn in (
                ("v2", fused_projection_dense, pack_dense),
                ("v2i", fused_projection_dense_int8, pack_dense_int8)):
            if tag in want:
                loops.append(("fused_projection_" + tag, loop,
                              pack_fn(gan.generator), x, gan.cfg))
    if "v3" in want:
        deep = seeded_deep_gan()
        perm = pack_generator(deep.generator, "s2d").perm[0]
        x = (deep.generate(g, n).reshape(n, -1) * 2.0 - 1.0)[:, perm]
        loops.append(("fused_projection_v3", fused_projection_s2d,
                      pack_s2d(deep.generator), x, deep.cfg))
    if "v4" in want:
        celeba = seeded_celeba_gan(args.config)
        p4 = pack_v4(celeba.generator)
        x = x_rows(p4, celeba.generate(g, 512) * 2.0 - 1.0) \
            .repeat_interleave(celeba.cfg.rec_rr, dim=0)
        loops.append(("fused_projection_v4", fused_projection_v4, p4, x,
                      celeba.cfg))
    for (name, loop, pack, x, cfg), chunk in [
            (lp, int(c)) for lp in loops for c in args.chunks.split(",")]:
        kw = dict(rec_iters=args.iters, rec_lr=cfg.rec_lr,
                  momentum=cfg.rec_momentum)
        n = x.shape[0]
        z0 = torch.randn(n, cfg.latent_dim, device="cuda", generator=g)

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
        extra = {}
        flop = {} if name.endswith(("v2", "v2i")) else \
            issued_flop(pack, n, args.iters)
        if name == "fused_projection_v4":
            extra["by_launch"] = by_launch(prof, v4_step_labels(pack),
                                           args.iters, flop)
            extra["config"] = args.config
        if flop:
            extra["issued_tflop"] = sum(flop.values()) / 1e12
            extra["bf16_peak_share"] = peak_share(sum(flop.values()),
                                                  total / 1e3)
        print(json.dumps({
            "loop": name, "rows": n, "iters": args.iters,
            "chunk": chunk or "default", "p": pack_width(pack),
            "call_ms": statistics.median(calls),
            "wall_ms": wall * 1e3, "device_ms": total / 1e3,
            "kernels": [dict(kernel=k[:120], launch=launch,
                             ms=us / 1e3, count=c,
                             share=us / total if total else None,
                             bf16_peak_share=peak_share(flop.get(launch),
                                                        us / 1e3))
                        for k, us, c in sorted(rows, key=lambda r: -r[1])
                        for launch in [launch_of(k) if name.endswith("v3")
                                       else None]],
            **extra}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
