"""Validation and throughput of the int8 fused projection (v2i) on the
trained flagship (port of the JAX package's scripts/int8_validate.py).

    python scripts/int8_validate_torch.py [--out PATH] [--device cuda]

On shared x and z0 (seeded), against the fp32 plain path (kernel="xla" on
a float32 copy of the weights):
  1. restart selection of v2i and of the bf16 kernel v2 (the control):
     argmin agreement and tie-aware material disagreement
     (eval/quality.py::tie_aware_disagreement);
  2. the best-restart loss: p95 |loss - reference| of each, the recon
     shift against the reference's chosen reconstruction and its residual;
  3. the int8 gate, eval/quality.py::int8_gate_ok (unchanged criterion),
     written as a stamp beside the export it was measured on
     (<output_dir>/export/int8_gate_cuda.json unless --out; never the JAX
     package's checkpoints/int8_gate.json), with the device record;
  4. v2 and v2i recon/s at --bench_batches images (R and L of the config),
     best of --repeats synchronized calls after one warm-up.
The defense refuses a run with no weight export. On the CPU the kernels'
requests run their plain paths (the stamp then says so in `paths`).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from defensegan_torch.cli.common import (add_cfg_args, cfg_from_args,
                                         device_from_args, device_record,
                                         load_gan)
from defensegan_torch.defense.project import sample_z0
from defensegan_torch.eval.quality import int8_gate_ok, tie_aware_disagreement
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.utils.misc import ensure_dir, generator_for

FLAGSHIP_CFG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "gans", "mnist_fast.yml")
CRITERION = ("int8 material disagreement <= max(0.03, bf16 + 0.005) and "
             "best-loss p95 delta <= max(1e-3, 2x the bf16 control's own "
             "p95 vs the fp32 plain path)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    add_cfg_args(ap)
    ap.set_defaults(cfg=FLAGSHIP_CFG)
    ap.add_argument("--out", default=None,
                    help="the stamp's path (default <output_dir>/export/"
                    "int8_gate_cuda.json)")
    ap.add_argument("--batch", type=int, default=256,
                    help="images of the gate")
    ap.add_argument("--bench_batches", type=int, nargs="*",
                    default=[4096, 16384])
    ap.add_argument("--repeats", type=int, default=3)
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(gan: DefenseGAN, kernel: str, batch: int, repeats: int,
          seed: int) -> dict:
    """recon/s of gan.reconstruct(kernel) at `batch` images: best of
    `repeats` synchronized calls after one warm-up."""
    dev = gan.device
    x = torch.rand((batch,) + tuple(gan.cfg.image_shape),
                   generator=generator_for(seed, dev), device=dev)
    gen = generator_for(seed + 1, dev)
    gan.reconstruct(x, gen, kernel=kernel)
    _sync(dev)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        gan.reconstruct(x, gen, kernel=kernel)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return {"batch": batch, "kernel": kernel, "path": gan.last_kernel,
            "recon_per_sec": batch / min(times),
            "ms_min": min(times) * 1e3}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = cfg_from_args(args)
    device = device_from_args(args)
    gan = load_gan(cfg, device, require_trained=True)
    ref_gan = DefenseGAN(cfg.replace(compute_dtype="float32"),
                         device=device).load(gan.step)

    x = torch.rand((args.batch,) + tuple(cfg.image_shape),
                   generator=generator_for(7, device), device=device)
    z0 = sample_z0(generator_for(11, device), args.batch, cfg.rec_rr,
                   cfg.latent_dim)
    ref = ref_gan.reconstruct(x, z0=z0, kernel="xla")
    got8 = gan.reconstruct(x, z0=z0, kernel="pallas_int8")
    path8 = gan.last_kernel
    got16 = gan.reconstruct(x, z0=z0, kernel="pallas")
    path16 = gan.last_kernel

    def np32(t):
        return t.detach().float().cpu().numpy()
    ref_l, l8, l16 = (np32(r.all_losses) for r in (ref, got8, got16))
    tie8 = tie_aware_disagreement(ref_l, l8)
    tie16 = tie_aware_disagreement(ref_l, l16)
    p95 = float(np.percentile(np.abs(np32(got8.loss) - np32(ref.loss)), 95))
    p95_16 = float(np.percentile(np.abs(np32(got16.loss) - np32(ref.loss)),
                                 95))
    xr = np32(ref.x_hat)
    resid = float(np.mean((xr - np32(x)) ** 2))
    shift8 = float(np.mean((np32(got8.x_hat) - xr) ** 2))
    shift16 = float(np.mean((np32(got16.x_hat) - xr) ** 2))
    ok = int8_gate_ok(tie8["material_disagreement"],
                      tie16["material_disagreement"], p95, p95_16)
    stamp = {
        "step": gan.step,
        "pass": bool(ok),
        "material_disagreement_int8": tie8["material_disagreement"],
        "material_disagreement_bf16": tie16["material_disagreement"],
        "best_loss_absdiff_p95": p95,
        "best_loss_absdiff_p95_bf16_control": p95_16,
        "recon_shift_mse_int8": shift8,
        "recon_shift_mse_bf16": shift16,
        "recon_residual_mse_xla": resid,
        "criterion": CRITERION,
        "batch": args.batch, "rec_rr": cfg.rec_rr,
        "rec_iters": cfg.rec_iters,
        "paths": {"int8": path8, "bf16": path16,
                  "reference": "xla float32"},
        "device": device_record(device),
        "package": "defensegan_torch",
    }
    out = args.out or os.path.join(cfg.output_dir, "export",
                                   "int8_gate_cuda.json")
    ensure_dir(os.path.dirname(out) or ".")
    with open(out, "w") as f:
        json.dump(stamp, f, indent=1)
    print(f"gate stamp ({'PASS' if ok else 'FAIL'}) -> {out}", flush=True)
    metrics = {
        "argmin_agreement_int8_vs_xla": float((ref_l.argmin(1)
                                               == l8.argmin(1)).mean()),
        "argmin_agreement_bf16_vs_xla": float((ref_l.argmin(1)
                                               == l16.argmin(1)).mean()),
        "material_disagreement_int8_vs_xla": tie8["material_disagreement"],
        "material_disagreement_bf16_vs_xla": tie16["material_disagreement"],
        "mean_regret_int8": tie8["mean_regret"],
        "mean_regret_bf16": tie16["mean_regret"],
        "tie_tau": tie8["tau"],
        "best_loss_mean_xla": float(np32(ref.loss).mean()),
        "best_loss_mean_int8": float(np32(got8.loss).mean()),
        "best_loss_mean_bf16": float(np32(got16.loss).mean()),
        "best_loss_absdiff_p95_int8": p95,
        "best_loss_absdiff_p95_bf16": p95_16,
        "recon_shift_mse_int8": shift8,
        "recon_shift_mse_bf16": shift16,
        "recon_residual_mse_xla": resid,
    }
    print(json.dumps(metrics), flush=True)
    benches = []
    for b in args.bench_batches:
        for label, kernel in (("v2_bf16", "pallas"),
                              ("v2i_int8", "pallas_int8")):
            row = dict(bench(gan, kernel, b, args.repeats, seed=b),
                       metric=f"{label}_batch{b}")
            benches.append(row)
            print(json.dumps(row), flush=True)
    return {"stamp": stamp, "stamp_path": out, "metrics": metrics,
            "bench": benches}


if __name__ == "__main__":
    main()
