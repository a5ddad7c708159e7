#!/usr/bin/env python3
"""Where a fused projection call spends its device time, per CUDA kernel.

Runs each hand-written loop of the PyTorch port (v2 bf16 and v2i int8 on
the flagship weights; v3 on the deep mnist.yml generator and v4 on the
64x64 celeba.yml generator, both with the smoke's seeded weights) once at
the smoke's main shape (1024 images x R 10 = 10240 rows; v4: 512 images x
R 2 = 1024 rows; L steps, default 20) under torch.profiler, and prints one
JSON line per loop: the device time of each kernel (the GEMM by epilogue,
the split-K reduction, the 3x3 grid convs, row quantization, casts)
summed over the call, its share, and the call's wall time under the
profiler, and the median of 3 synchronized calls outside it (call_ms).
`by_launch` names every launch of a step (kernels are shared between
launches, so it goes by the order of the launches on the stream: for v2
the four products, the fc backward as its split products and their sum +
momentum; for v2i also the two quantize passes; for v3 and v4 the fc
products, the convs and conv B, v3's conv B section one launch where its
entry fuses it), each with the operations it issues (the padded widths:
K in whole slabs, N in whole 128-column tiles; skipped border taps left
out) and its share of the peak of their type (bf16 989 TFLOP/s, int8
1979 TOP/s);
--config runs v4 on another 64x64 config (celeba_wide, imagenet64) at the
same rows. --chunks repeats this for each row-chunk size of the wrappers
(0: their default, one chunk up to the scratch cap). --kernel v3p and ilp
profile two of v3's layout experiments the same way (v3p on its padded
grid, conv A on v3's 361 taps; ilp with conv A on the ping-pong schedule).
--kernel packed profiles the tap-packed experiment the same way (its conv
B section one launch, where the parent's loop has v3's three).
--kernel conva measures conv A's ceilings at the same rows, both ways, on
each schedule (experiments/v3_ilp.py::conv_a): the conv, the L2 feed
alone (the producer's copies, no wgmma) and the products alone (no
copies), each launch's device time under the profiler, its issued
operations' share of the bf16 peak and the bytes the copies bring from L2
per second; and the backward with its taps in one chain (packed's, no
per-tap fold), the conv and its products alone.
--kernel stream64 times the stream64 level (experiments/stream64_probe.py,
batch 512, the probe's draws) per level and per direction: each launch's
device time, the 64-deep K slabs it issues and their share of the bf16
peak; with the zero blocks skipped and with every block issued.
--rows sets the rows of the v2, v2i and v3 loops (e.g. 64, a one-image
request's 10 rows as the wrapper pads them). --root takes the port (and chip_smoke.py) from another checkout, e.g. the
parent unpacked by `git archive`, so that two versions are profiled in
one call. Needs one CUDA device:

    python3 scripts/torch_kernel_profile.py \
        [--kernel all|v2|v2i|v3|v4|v3p|ilp|packed|conva|stream64] \
        [--iters 20] [--rows 10240] [--chunks 0,4096] [--config celeba]
        [--root DIR]
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
PEAK_INT8 = 1979e12     # dense int8 peak of one H100 SXM (data sheet)
TILE_N = 128            # columns of a GEMM tile (csrc/gemm_sm90.cuh)
PROFILE_WINDOWS = 3     # profiled windows a launch count may take

# the launches of one step of each loop, in stream order; the fc backward
# is two launches (the split products, then their sum + the momentum)
FC_BACKWARD = ("fc backward: split products",
               "fc backward: split sum + momentum")
V2_LAUNCHES = ("fc forward z @ W1 (+ bias, relu)",
               "h @ D (+ tanh gradient)",
               "do @ D^T (+ relu mask)") + FC_BACKWARD
V2I_LAUNCHES = ("fc forward z @ W1 (+ bias, relu, row amax)",
                "quantize h",
                "hq @ Dq int8 (+ dequant, tanh gradient, row amax)",
                "quantize do",
                "gq @ DTq int8 (+ dequant, relu mask)") + FC_BACKWARD
V3_LAUNCHES = ("fc forward", "conv A forward",
               "conv B forward (packed product)",
               "conv B tap sum + tanh gradient + pack", "conv B backward",
               "conv A backward") + FC_BACKWARD
# the step with conv B's section as one launch: the packed loop's, and
# v3's where the section's shapes fit
PACKED_LAUNCHES = ("fc forward", "conv A forward",
                   "conv B section (forward, tap sum, tanh gradient, "
                   "backward)", "conv A backward") + FC_BACKWARD
# kernels of the libraries (C++ namespace fpk, and the loops' own)
LIBRARY_KERNELS = ("fpk::", "quant_rows", "tanh_grad_pack")


def pack_width(pack) -> int:
    """The padded output width P the kernel runs over (v2, v2i); for v3
    the s2d output width, for v4 the double-blocked one."""
    base = getattr(pack, "base", pack)
    if hasattr(base, "d"):
        return base.d.shape[1]
    if hasattr(base, "levels"):
        return base.final_g ** 2 * base.out_lanes
    return base.grid_hw ** 2 * base.cb


V3_LOOPS = ("fused_projection_v3", "fused_projection_v3p",
            "fused_projection_v3_ilp")     # v3's three-launch step
PACKED = "fused_projection_v3_packed"


def packed_is_fused() -> bool:
    """Whether the imported port's packed loop runs conv B's section as
    one launch (a parent checkout's may run v3's three)."""
    from defensegan_torch.experiments import v3_packed
    return getattr(v3_packed, "FUSED_CONV_B", False)


def v3_is_fused(pack) -> bool:
    """Whether the imported port's v3 runs conv B's section as one launch
    on this pack (a parent checkout's, which lacks `conv_b_fuses`, runs
    three)."""
    try:
        from defensegan_torch.kernels.fused_projection_v3 import (
            conv_b_fuses, padded_s2d)
    except ImportError:
        return False
    return conv_b_fuses(padded_s2d(pack))


def step_labels(name: str, pack):
    """The launches of one step of the loop, in stream order."""
    if name.endswith("v2"):
        return V2_LAUNCHES
    if name.endswith("v2i"):
        return V2I_LAUNCHES
    if name == PACKED:
        return PACKED_LAUNCHES if packed_is_fused() else V3_LAUNCHES
    if name == "fused_projection_v3" and v3_is_fused(pack):
        return PACKED_LAUNCHES
    if name in V3_LOOPS:
        return V3_LAUNCHES
    lv = level_names(pack)
    return (("fc forward",) + tuple(f"{n} forward" for n in lv)
            + tuple(f"{n} backward" for n in reversed(lv)) + FC_BACKWARD)


def taps(g: int) -> int:
    """Valid taps of a 3x3 SAME conv on a g x g grid, over all pixels:
    along each axis g + 2(g - 1) (pixel, offset) pairs stay in the grid
    (kernels/grid.py::tap_masks summed)."""
    return (3 * g - 2) ** 2


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def gemm_ops(n: float, k: int, cols: int, int8: bool = False) -> float:
    """Operations a GEMM launch issues over n row-steps: K up to whole
    128-byte slabs, N up to whole 128-column tiles (zero-filled by TMA)."""
    return 2.0 * n * _up(k, 128 if int8 else 64) * _up(cols, TILE_N)


def issued(name: str, pack, rows: int, iters: int) -> dict:
    """{launch label: (operations it issues over `iters` steps at the
    kernel's padded widths, the peak of their type)}."""
    from defensegan_torch.kernels.fused_projection_v2 import padded_fc
    from defensegan_torch.kernels.fused_projection_v3 import padded_s2d
    from defensegan_torch.kernels.fused_projection_v4 import padded_v4
    n = float(rows * iters)
    bf, i8 = PEAK_BF16, PEAK_INT8
    if name.endswith(("v2", "v2i")):
        base = getattr(pack, "base", pack)
        kp, fp = padded_fc(base)[0].shape
        p = base.d.shape[1]
        fc = (gemm_ops(n, kp, fp), bf)
        back = (gemm_ops(n, fp, kp), bf)
        if name.endswith("v2"):
            d_ops, dt_ops = gemm_ops(n, fp, p), gemm_ops(n, p, fp)
            if getattr(base, "d_slabs", None):  # the listed slabs' walk
                d_ops *= base.d_slabs.issued / base.d_slabs.dense
                dt_ops *= base.dt_slabs.issued / base.dt_slabs.dense
            return dict(zip(V2_LAUNCHES, (fc, (d_ops, bf), (dt_ops, bf),
                                          back)))
        return dict(zip(V2I_LAUNCHES, (
            fc, (0.0, bf), (gemm_ops(n, fp, p, True), i8), (0.0, bf),
            (gemm_ops(n, p, fp, True), i8), back)))
    if hasattr(pack, "levels"):
        pp = padded_v4(pack)
        f = pp.base_hw ** 2 * pp.c0
        out = {"fc forward": (gemm_ops(n, pp.z_dim, f), bf),
               FC_BACKWARD[0]: (gemm_ops(n, f, pp.z_dim), bf)}
        for lname, lv in zip(level_names(pack), pp.levels):
            conv = (2.0 * n * taps(lv.g) * lv.ci * lv.co, bf)
            out[f"{lname} forward"] = out[f"{lname} backward"] = conv
        return out
    pp = padded_s2d(pack)
    # v3p's GEMMs run over its padded grid's g*(g+1) pixels; its conv A
    # issues v3's taps
    p2 = pp.grid_hw * (pp.grid_hw + (name == "fused_projection_v3p"))
    f = p2 * pp.c0
    conv_a = (2.0 * n * taps(pp.grid_hw) * pp.c0 * pp.ca, bf)
    out = {"fc forward": (gemm_ops(n, pp.z_dim, f), bf),
           FC_BACKWARD[0]: (gemm_ops(n, f, pp.z_dim), bf),
           "conv A forward": conv_a, "conv A backward": conv_a,
           "conv B forward (packed product)":
               (gemm_ops(n * p2, pp.ca, pp.kbp.shape[1]), bf),
           "conv B backward": (gemm_ops(n * p2, pp.kbpt.shape[0], pp.ca),
                               bf)}
    # the fused section: a latent's 64-row tile, N 144 forward, K 144
    # backward (9 taps of cb 16)
    out[PACKED_LAUNCHES[2]] = (2.0 * 2 * n * 64 * pp.ca * 9 * pp.cb, bf)
    return out


def peak_share(ops, peak, ms):
    return None if not ops or not ms else ops / (ms * 1e-3) / peak


def level_names(pack):
    return [f"level {i} (g {l.g}, {l.ci} -> {l.co})"
            for i, l in enumerate(pack.levels)]


def by_launch(prof, labels, iters: int, ops: dict):
    """Device time by position in the step: the library's kernels in
    stream order are, for each row chunk, one cast, then `iters` steps of
    len(labels) launches; each launch with its issued operations and its share of the
    peak of their type (bf16 989, int8 1979 TOP/s)."""
    from torch.autograd import DeviceType
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and any(k in e.name for k in LIBRARY_KERNELS)),
                 key=lambda e: e.time_range.start)
    per_call = 1 + iters * len(labels)        # each row chunk's call
    if not evs or len(evs) % per_call:
        return {"error": f"{len(evs)} device kernels, not a multiple of "
                         f"{per_call}"}
    us = [0.0] * len(labels)
    for i, e in enumerate(evs):
        if i % per_call:
            us[(i % per_call - 1) % len(labels)] += e.time_range.elapsed_us()
    total = sum(us)
    rows = []
    for name, t in zip(labels, us):
        op, peak = ops.get(name, (0.0, PEAK_BF16))
        rows.append({"launch": name, "ms": t / 1e3, "share": t / total,
                     "issued_tera_ops": op / 1e12,
                     "peak": "int8" if peak == PEAK_INT8 else "bf16",
                     "peak_share": peak_share(op, peak, t / 1e3)})
    return rows


def conv_a_bytes(rows: int, g: int, cin: int, cout: int) -> float:
    """Bytes conv A's copies bring from L2 into shared memory: per tile
    (128 rows, one pixel, BN channels) and counted tap, cin / 64 slabs of
    A (128 x 64 bf16) and of B (64 x BN)."""
    bn = 128 if cout % 128 == 0 else 64
    slab = 128 * 64 * 2 + 64 * bn * 2
    return float(_up(rows, 128) // 128 * taps(g) * (cout // bn)
                 * (cin // 64) * slab)


def _conv_label(name: str):
    return "conv" if "conv3x3_sm90" in name else None


def conv_a_ceilings(pack, rows: int, reps: int = 10, seed: int = 0) -> list:
    """Conv A at `rows` rows, forward (c0 -> ca, one chain) and backward
    (ca -> c0, each tap rounded), on v3's and ilp's schedules: the conv,
    the feed alone and the products alone (v3_ilp.conv_a's probes). Each
    launch's device time is the median over `reps` launches under
    torch.profiler; its share of the bf16 peak counts the operations the
    conv issues (skipped border taps left out), its L2 rate the bytes
    its copies bring (conv_a_bytes)."""
    import torch

    from defensegan_torch.experiments import v3_ilp
    from defensegan_torch.experiments.v3_ilp import conv_a
    from defensegan_torch.kernels.fused_projection_v3 import padded_s2d
    pp = padded_s2d(pack)
    g, c0, ca = pp.grid_hw, pp.c0, pp.ca
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h0 = torch.relu(torch.randn(rows, g * g * c0, device="cuda",
                                generator=gen)).to(torch.bfloat16)
    dh1 = torch.randn(rows, g * g * ca, device="cuda",
                      generator=gen).to(torch.bfloat16)
    # the backward reads dh1 and writes dh0 over h0, masked by h0 > 0
    ways = {"forward": (h0, pp.ka, c0, ca, dict(mode="chain", bias=pp.ba)),
            "backward": (dh1, pp.kat, ca, c0, dict(mode="backward", h=h0))}
    # the feed alone is the same launch on either schedule
    runs = {way: (("coop", "whole"), ("coop", "feed"), ("coop", "math"),
                  ("pingpong", "whole"), ("pingpong", "math"))
            for way in ways}
    if "backward_chain" in getattr(v3_ilp, "CONV_A_MODES", ()):
        # the backward's taps in one chain: what the per-tap fold costs
        ways["backward_chain"] = (dh1, pp.kat, ca, c0,
                                  dict(mode="backward_chain", h=h0))
        runs["backward_chain"] = (("coop", "whole"), ("coop", "math"))
    out = []
    for way, (inp, w, cin, cout, kw) in ways.items():
        ops = 2.0 * rows * taps(g) * cin * cout
        moved = conv_a_bytes(rows, g, cin, cout)
        for sched, probe in runs[way]:
            def run():
                return conv_a(inp, w, g, schedule=sched, probe=probe, **kw)
            ms_all = _launch_ms(run, reps, _conv_label, ("conv",)).get(
                "conv", [])
            if len(ms_all) != reps:
                raise RuntimeError(f"conv A {way} {sched} {probe}: "
                                   f"{len(ms_all)} launches profiled, not "
                                   f"{reps}")
            ms = statistics.median(ms_all)
            out.append({
                "way": way, "schedule": sched, "probe": probe, "rows": rows,
                "ms": ms, "ms_all": ms_all,
                "issued_tera_ops": ops / 1e12,
                "peak_share": peak_share(ops, PEAK_BF16, ms),
                "l2_gbytes": moved / 1e9,
                "l2_tb_per_s": moved / (ms * 1e-3) / 1e12})
    return out


def _launch_ms(run, reps: int, pick, labels) -> dict:
    """{label: device ms of each launch, over `reps` calls of run()} for
    the device kernels that pick(name) labels (None: not counted). The
    profiler can drop kernel records from a window (3 of conv A's 10 on an
    H100 once), so a window that holds other than `reps` records of one of
    `labels` is profiled again, up to PROFILE_WINDOWS windows; the last
    window is returned and the callers refuse a count other than `reps`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()                                            # build + warm-up
    torch.cuda.synchronize()
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            label = pick(e.name) if e.device_type == DeviceType.CUDA \
                else None
            if label is not None:
                out.setdefault(label, []).append(
                    e.time_range.elapsed_us() / 1e3)
        if all(len(out.get(label, ())) == reps for label in labels):
            break
    return out


def stream64_slabs(sp, pack, batch: int, bn: int, skip: bool) -> dict:
    """64-deep K slabs each direction of the level issues at `batch`
    images, and their multiply-adds: every block (skip False) or the
    zero blocks left out (the port's stream64_probe.issued_slabs)."""
    g, ci, co4 = pack.g, pack.ci, 4 * pack.co
    m_tiles = _up(batch, 128) // 128
    if skip:
        zero = pack.zero.cpu().numpy()
        fwd = int(sp.issued_slabs(zero, g, ci, co4, bn, False).sum())
        bwd = int(sp.issued_slabs(zero, g, ci, co4, bn, True).sum())
    else:
        fwd = taps(g) * (co4 // bn) * (ci // 64)
        bwd = taps(g) * (co4 // 64) * (ci // 128)
    return {"forward": (m_tiles * fwd, 128 * 64 * bn),
            "backward": (m_tiles * bwd, 128 * 64 * 128)}


def stream64_levels(batch: int = 512, reps: int = 10, seed: int = 0) -> list:
    """The stream64 level per level and direction: each launch's device
    time (median of `reps` calls under torch.profiler), the K slabs it
    issues and their share of the bf16 peak; for the port's kernel with
    the zero blocks skipped and with every block issued, for a parent's
    as it is."""
    import torch
    from defensegan_torch.experiments import stream64_probe as sp
    torch.backends.cuda.matmul.allow_tf32 = False
    skips = hasattr(sp, "zero_blocks")
    out = []
    for lvl, (g, ci, co) in sp.LEVELS.items():
        a = sp.draw_arrays(lvl, batch, seed=seed)
        pack = sp.level_tensors(*sp.pack_level(a["w"], a["b"], a["scale"],
                                               a["shift"]), g, "cuda")
        x = torch.as_tensor(a["x0"]).cuda()
        cot = sp.to_phase_blocked(torch.as_tensor(a["cot"]).cuda()) \
            .to(torch.bfloat16)
        bn = 128 if 4 * co % 128 == 0 else 64       # the kernel's tiles
        configs = [("skip", True), ("all", False)] if skips \
            else [("all", False)]

        def pick(name):
            if "conv3x3_sm90" not in name:
                return None
            return "forward" if "EpiReluCot" in name else "backward"
        for label, skip in configs:
            kw = dict(skip=skip) if skips else {}
            times = _launch_ms(lambda: sp.fused_level(x, cot, pack, **kw),
                               reps, pick, ("forward", "backward"))
            slabs = stream64_slabs(sp, pack, batch, bn, skip)
            rec = {"level": lvl, "config": label, "batch": batch, "bn": bn}
            for way, (n, macs) in slabs.items():
                ms_all = times.get(way, [])
                if len(ms_all) != reps:
                    raise RuntimeError(f"stream64 L{lvl} {label} {way}: "
                                       f"{len(ms_all)} launches, not {reps}")
                ms = statistics.median(ms_all)
                rec[way] = {"ms": ms, "ms_all": ms_all, "issued_slabs": n,
                            "peak_share": peak_share(2.0 * n * macs,
                                                     PEAK_BF16, ms)}
            rec["ms"] = rec["forward"]["ms"] + rec["backward"]["ms"]
            out.append(rec)
        del pack, x, cot
    return out


def profile_loop(name: str, loop, pack, x, cfg, iters: int,
                 chunk: int = 0, seed: int = 0) -> dict:
    """One loop's record: the median of 3 synchronized calls (after a
    warm-up), then one call under torch.profiler: device time by kernel
    and `by_launch` (the step's launches with their shares of the peak;
    the call is profiled again, up to PROFILE_WINDOWS times, while the
    window's records are not whole steps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from defensegan_torch.utils.profiling import device_rows
    kw = dict(rec_iters=iters, rec_lr=cfg.rec_lr, momentum=cfg.rec_momentum)
    n = x.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    z0 = torch.randn(n, cfg.latent_dim, device="cuda", generator=gen)

    def run():
        loop(pack, x, z0, **kw, **({"chunk": chunk} if chunk else {}))
        torch.cuda.synchronize()
    run()                                         # build + warm-up
    calls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        calls.append((time.perf_counter() - t0) * 1e3)
    ops = issued(name, pack, n, iters)
    for _ in range(PROFILE_WINDOWS):     # again if records were dropped
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall = time.perf_counter() - t0
        launches = by_launch(prof, step_labels(name, pack), iters, ops)
        if isinstance(launches, list):
            break
    rows = device_rows(prof)
    total = sum(r[1] for r in rows)
    return {
        "loop": name, "rows": n, "iters": iters,
        "chunk": chunk or "default", "p": pack_width(pack),
        "call_ms": statistics.median(calls),
        "wall_ms": wall * 1e3, "device_ms": total / 1e3,
        "issued_tera_ops": {
            kind: sum(o for o, pk in ops.values() if pk == peak) / 1e12
            for kind, peak in (("bf16", PEAK_BF16), ("int8", PEAK_INT8))},
        "by_launch": launches,
        "kernels": [dict(kernel=k[:120], ms=us / 1e3, count=c,
                         share=us / total if total else None)
                    for k, us, c in sorted(rows, key=lambda r: -r[1])]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="all",
                    choices=("all", "v2", "v2i", "v3", "v4", "v3p", "ilp",
                             "packed", "conva", "stream64"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--config", default="celeba",
                    choices=("celeba", "celeba_wide", "imagenet64"),
                    help="the 64x64 config that v4 runs")
    ap.add_argument("--chunks", default="0",
                    help="comma-separated rows per library call; 0 = the "
                         "wrapper's default")
    ap.add_argument("--rows", type=int, default=10240,
                    help="rows of the v2, v2i and v3 loops")
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose port is profiled")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
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
    from defensegan_torch.experiments.fused_projection_v3p import (
        fused_projection_s2d_padded)
    from defensegan_torch.experiments.v3_ilp import fused_projection_ilp
    from defensegan_torch.experiments.v3_packed import run_packed
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(json.dumps({"root": os.path.abspath(args.root)}), flush=True)
    if args.kernel == "stream64":
        for rec in stream64_levels():
            print(json.dumps({"stream64": rec}), flush=True)
        return 0
    g = torch.Generator(device="cuda").manual_seed(0)
    n = args.rows
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
    deep_loops = {"v3": ("fused_projection_v3", fused_projection_s2d),
                  "v3p": ("fused_projection_v3p",
                          fused_projection_s2d_padded),
                  "ilp": ("fused_projection_v3_ilp", fused_projection_ilp),
                  "packed": (PACKED, run_packed)}
    if any(t in want for t in deep_loops) or "conva" in want:
        deep = seeded_deep_gan()
        pack3 = pack_s2d(deep.generator)
        perm = pack_generator(deep.generator, "s2d").perm[0]
        x = (deep.generate(g, n).reshape(n, -1) * 2.0 - 1.0)[:, perm]
        loops += [(*deep_loops[t], pack3, x, deep.cfg) for t in deep_loops
                  if t in want]
    if "conva" in want:
        for rec in conv_a_ceilings(pack3, n):
            print(json.dumps({"conv_a": rec}), flush=True)
    if "v4" in want:
        celeba = seeded_celeba_gan(args.config)
        p4 = pack_v4(celeba.generator)
        x = x_rows(p4, celeba.generate(g, 512) * 2.0 - 1.0) \
            .repeat_interleave(celeba.cfg.rec_rr, dim=0)
        loops.append(("fused_projection_v4", fused_projection_v4, p4, x,
                      celeba.cfg))
    for (name, loop, pack, x, cfg), chunk in [
            (lp, int(c)) for lp in loops for c in args.chunks.split(",")]:
        rec = profile_loop(name, loop, pack, x, cfg, args.iters, chunk)
        if name.endswith("v4"):
            rec["config"] = args.config
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
