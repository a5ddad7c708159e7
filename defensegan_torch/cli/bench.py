"""The north-star benchmark's worker: MNIST Defense-GAN reconstructions/sec
on one card (port of the JAX package's bench.py measurement half; the
supervisor, its deadline and the flags are the root bench_torch.py).

Measures the projection defense (R = 10 restarts x L = 200 momentum steps
on z, argmin-restart selection) cheap first and prints a cumulative JSON
record on stdout after every leg: headline `xla` (the plain PyTorch path)
-> headline `pallas` (kernel v2, bf16) -> headline `pallas_int8` (v2i, only
with a passing card stamp of the int8 gate for the export on disk) ->
deep `pallas` (v3 on `mnist.yml`). Each later line upgrades the record;
every line but the last carries "partial": true. Progress, the stage
lines the supervisor names a kill by, and each leg's kernel launches go to
stderr.

Record: bench.py's keys ("metric", "value", "unit", "vs_baseline",
"gen_arch", "gen_dim", "kernel", "deep_value", "deep_kernel",
"deep_vs_baseline", "deep_unit") plus "device" (the card's name and power
limit, cli/common.py::device_record), with vs_baseline = value / 1000.
"""

from __future__ import annotations

import json
import os
import sys
import time

BASELINE_TARGET = 1000.0  # recon/s/chip: BASELINE.json's target for the
# project (the reference publishes no throughput); not a time measured on
# any chip, kept so that vs_baseline means what it means in bench.py
CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "gans")
SEED = 0

# Wall seconds a leg may need, to decide whether it still fits the
# deadline: a warm run's leg times at the defaults (16384 / 4096 images,
# R 10, L 200: load, one warm-up, 3 timed calls; 53, 8, 10 and 7 s on an
# NVIDIA H100 80GB HBM3, 700.00 W, bench_torch.py, PERF.md section 5),
# padded about 2x.
LEG_EST_S = {"headline_xla": 110.0, "headline_pallas": 16.0,
             "headline_int8": 20.0, "deep_pallas": 15.0}

# the kernel library each leg launches (kernels/build.py names)
LEG_LIBRARIES = {"headline_pallas": "fused_projection_v2",
                 "headline_int8": "fused_projection_v2i",
                 "deep_pallas": "fused_projection_v3"}
LAUNCHES_LINE = "worker: leg {} launches "   # + the leg's counts as JSON


def leg_launches(stderr: str) -> dict:
    """{leg: {library: launches}} from the worker's stderr."""
    head, tail = LAUNCHES_LINE.split("{}")
    out = {}
    for line in stderr.splitlines():
        if line.startswith(head) and tail in line:
            leg, _, counts = line[len(head):].partition(tail)
            out[leg] = json.loads(counts)
    return out


def export_step(output_dir: str):
    """The step of the weight export DefenseGAN.load reads from
    output_dir (its manifest's, else the file's), or None without one."""
    from defensegan_torch.ckpt.bridge import export_path
    try:
        path = export_path(output_dir)
    except FileNotFoundError:
        return None
    try:
        with open(path[:-4] + ".json") as f:
            return json.load(f).get("step")
    except (OSError, ValueError):
        return int(os.path.basename(path)[:-4])


def int8_gate_stamp(output_dir: str):
    """The card's int8 gate stamp (<output_dir>/export/int8_gate_cuda.json,
    written by scripts/int8_validate_torch.py) when it passed, was
    measured on a CUDA card and on the export step on disk; else None.

    The JAX package's checkpoints/int8_gate.json is never read: it was
    measured through Pallas on a TPU. A retrained run whose export step
    moved must not inherit the gated pallas_int8 request."""
    path = os.path.join(output_dir, "export", "int8_gate_cuda.json")
    try:
        with open(path) as f:
            stamp = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(stamp, dict) or stamp.get("pass") is not True:
        return None
    device = stamp.get("device")
    if not isinstance(device, dict) or device.get("type") != "cuda":
        return None
    if stamp.get("step") != export_step(output_dir):
        return None
    return stamp


def measure(cfg_path, batch, rec_rr, rec_iters, repeats, kernel,
            trace_dir=None, fallback_to_auto=False, device="cuda"):
    """Measure one (config, kernel) leg. Returns (recon/s, kernel, cfg).

    recon/s is batch over the fastest of `repeats` timed calls, after one
    warm-up; each call ends in a host fetch of the output's sum after a
    synchronize. The min, as bench.py takes it (chip_smoke.py phase 5
    takes a median at 1024 images). The returned kernel names the loop
    that ran (DefenseGAN.last_kernel).

    kernel is an explicit request. fallback_to_auto: an unrunnable request
    degrades to the auto resolution with a stderr note; otherwise it
    raises RuntimeError ("not runnable"). The port's resolver raises
    where the JAX one degrades quietly, and serves pallas_int8 on a deep
    generator with the bf16 v3: both count as unrunnable here."""
    import torch

    from defensegan_torch.configs import load_config
    from defensegan_torch.gan import DefenseGAN
    from defensegan_torch.gan.defense_gan import resolve_projection_kernel
    from defensegan_torch.utils.misc import fold_seed, generator_for

    dev = torch.device(device)
    cfg = load_config(cfg_path, {"rec_rr": rec_rr, "rec_iters": rec_iters})
    gan = DefenseGAN(cfg, device=dev)
    if gan.can_load():
        gan.load()  # trained weights when available; a seeded init does
        # the same work otherwise

    try:
        resolved = resolve_projection_kernel(gan, requested=kernel)
    except NotImplementedError as e:
        resolved, why = None, str(e)
    else:
        why = f"would degrade to {resolved}"
    if resolved != kernel:
        if not fallback_to_auto:
            raise RuntimeError(f"kernel {kernel} is not runnable for this "
                               f"topology/batch ({why})")
        resolved = resolve_projection_kernel(gan, requested="auto")
        print(f"note: kernel {kernel} not runnable for this topology/"
              f"batch; measuring auto resolution {resolved}",
              file=sys.stderr)

    x = torch.rand((batch,) + tuple(cfg.image_shape),
                   generator=generator_for(SEED, dev), device=dev)
    z_seed = fold_seed(SEED, 1)

    def run(i=None):
        gen = generator_for(z_seed if i is None else fold_seed(z_seed, i),
                            dev)
        x_hat = gan.reconstruct(x, gen, kernel=resolved).x_hat
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        float(x_hat.sum())  # the barrier: a host fetch of the output

    t0 = time.perf_counter()
    run()  # warm-up: the reconstructor's pack and the first launches
    label = gan.last_kernel
    print(f"  [{os.path.basename(cfg_path)} {label}] load+first "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        run(i)
        times.append(time.perf_counter() - t0)
    if trace_dir:
        from defensegan_torch.utils.profiling import trace
        with trace(trace_dir) as path:
            run(999)
        print(f"profiler trace written to {path}", file=sys.stderr)
    return batch / min(times), label, cfg


def _claim_device(name: str):
    """The device the legs run on. A CUDA request initializes the card
    (raising without one: there is no fallback to the CPU)."""
    import torch

    dev = torch.device(name)
    if dev.type != "cuda":
        print(f"worker: device {dev} (not a measurement of the card)",
              file=sys.stderr, flush=True)
        return dev
    print("worker: CUDA init (blocks while the driver or another process "
          "holds the card)...", file=sys.stderr, flush=True)
    t0 = time.monotonic()
    from defensegan_torch.gan.defense_gan import default_device
    default_device()  # raises without a CUDA device
    torch.cuda.init()
    print(f"worker: CUDA {torch.cuda.get_device_name(dev)} "
          f"({torch.cuda.device_count()} device(s)) in "
          f"{time.monotonic() - t0:.0f}s", file=sys.stderr, flush=True)
    return dev


def run_worker(args):
    """Measure legs cheap-first; print a cumulative record after each.

    stdout carries ONLY record lines (the supervisor relays them); all
    progress goes to stderr. The deadline here is advisory (skip legs that
    can't fit); the supervisor's kill is the hard enforcement."""
    deadline = (time.monotonic() + args.deadline) if args.deadline else None

    dev = _claim_device(args.device)
    import torch

    from defensegan_torch.cli.common import device_record
    from defensegan_torch.configs import load_config
    from defensegan_torch.kernels import build
    print("worker: TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
          f"{torch.backends.cudnn.allow_tf32} (PyTorch's defaults; the "
          "xla leg's speed depends on them)", file=sys.stderr, flush=True)

    def remaining():
        return float("inf") if deadline is None else deadline - time.monotonic()

    cfg_path = args.cfg or os.path.join(CFG_DIR, "mnist_fast.yml")
    record = {}
    device = device_record(dev)

    def emit(partial=True):
        rec = dict(record, device=device)
        if partial:
            rec["partial"] = True
        print(json.dumps(rec), flush=True)

    def headline(value, kernel, cfg):
        v2 = round(value, 2)
        # vs_baseline recomputes exactly from the rounded emitted value
        record.update({
            "metric": "mnist_reconstructions_per_sec_per_chip",
            "value": v2,
            "unit": f"recon/s (R={args.rec_rr}, L={args.rec_iters}, "
                    f"batch={args.batch}, {kernel}, gen={cfg.gen_arch}/"
                    f"dim{cfg.gen_dim})",
            "vs_baseline": round(v2 / BASELINE_TARGET, 4),
            "gen_arch": cfg.gen_arch,
            "gen_dim": cfg.gen_dim,
            "kernel": kernel,
        })

    def deep(value, kernel, cfg):
        v2 = round(value, 2)
        record.update({
            "deep_value": v2,
            "deep_kernel": kernel,
            "deep_vs_baseline": round(v2 / BASELINE_TARGET, 4),
            "deep_unit": f"recon/s (R={args.rec_rr}, L={args.rec_iters}, "
                         f"batch={args.deep_batch}, {kernel}, "
                         f"gen={cfg.gen_arch}/dim{cfg.gen_dim})",
        })

    # leg plan, cheap-first. A leg only ever UPGRADES the record: the
    # headline legs overwrite value/kernel (xla -> pallas -> int8), the
    # deep leg adds deep_* fields. --kernel overrides the headline plan
    # with exactly one explicit leg (and the deep leg keeps auto).
    if args.kernel == "auto":
        hcfg = load_config(cfg_path)
        want_int8 = (hcfg.gen_arch == "wide"
                     and int8_gate_stamp(hcfg.output_dir) is not None)
        if hcfg.gen_arch == "wide" and not want_int8:
            print("note: no passing card stamp of the int8 gate for the "
                  f"export under {hcfg.output_dir} (run scripts/"
                  "int8_validate_torch.py); topping out at bf16 pallas",
                  file=sys.stderr)
        plan = [("headline_xla", "xla"), ("headline_pallas", "pallas")]
        if want_int8:
            plan.append(("headline_int8", "pallas_int8"))
    else:
        plan = [("headline_" + args.kernel, args.kernel)]
    if args.deep_cfg:
        plan.append(("deep_pallas", None))  # deep leg, auto kernel

    if dev.type == "cuda":
        # the cold nvcc build plays the part of bench.py's first Mosaic
        # compile: a kill during it names this stage
        names = sorted({LEG_LIBRARIES[leg] for leg, _ in plan
                        if leg in LEG_LIBRARIES})
        print(f"worker: building kernels {', '.join(names)} (nvcc, cold "
              "unless build/kernels/ holds them)...", file=sys.stderr,
              flush=True)
        t0 = time.monotonic()
        build.build(names)
        print(f"worker: kernels ready in {time.monotonic() - t0:.1f}s",
              file=sys.stderr, flush=True)

    last_headline = [l for l, _ in plan if l.startswith("headline")][-1]
    for i, (leg, kernel) in enumerate(plan):
        est = LEG_EST_S.get(leg, 150.0)
        if i > 0 and remaining() < est:
            print(f"deadline: skipping leg {leg} (need ~{est:.0f}s, "
                  f"{remaining():.0f}s left)", file=sys.stderr)
            continue
        t0 = time.perf_counter()
        build.reset_launches()
        try:
            if leg.startswith("headline"):
                v, k, cfg = measure(cfg_path, args.batch, args.rec_rr,
                                    args.rec_iters, args.repeats, kernel,
                                    trace_dir=(args.trace
                                               if leg == last_headline
                                               else None),
                                    fallback_to_auto=(args.kernel == "auto"),
                                    device=dev)
                headline(v, k, cfg)
            else:
                v, k, cfg = measure(args.deep_cfg, args.deep_batch,
                                    args.rec_rr, args.rec_iters,
                                    args.repeats, "pallas",
                                    fallback_to_auto=True, device=dev)
                deep(v, k, cfg)
        except Exception as e:  # a failed leg must not void earlier legs
            print(f"leg {leg} failed after {time.perf_counter()-t0:.0f}s: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            continue
        launches = {n: c for n, c in build.LAUNCHES.items() if c}
        print(LAUNCHES_LINE.format(leg) + json.dumps(launches),
              file=sys.stderr, flush=True)
        if "value" in record and leg != plan[-1][0]:
            emit(partial=True)  # a later line strictly upgrades this one
        print(f"  leg {leg} done in {time.perf_counter()-t0:.0f}s "
              f"({remaining():.0f}s budget left)", file=sys.stderr)

    if "value" not in record:
        sys.exit(3)  # supervisor emits the diagnostic record
    emit(partial=False)  # the final, best record: the driver's line
    return 0
