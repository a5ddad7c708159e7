"""Serving-latency benchmark of the DefendedPipeline (port of the JAX
package's scripts/serving_bench.py).

A calibrated DefendedPipeline (purify + classify + flag in one projection
pass, defense/pipeline.py) as an operator would deploy it: end-to-end
wall clock of predict() across batch sizes, the latency / throughput
curve of defended inference. Per batch size one warm-up call, then
--repeats timed calls; reports min / median latency and images/s (batch /
min latency). The time is the host clock around predict(), which returns
numpy arrays (it waits for the device).

Needs the classifier cached under output/classifiers_torch/<type>_model<M>
(whitebox_torch.py trains and caches it). Writes one JSONL row per batch
to <results_dir>/serving_bench.jsonl (the JAX script's keys plus `device`
and `package`) and prints a summary table.

    python scripts/serving_bench_torch.py --cfg output/gans/mnist_fast \\
        --model A [--batches 1 16 256 1024 4096 16384] [--kernel auto]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from defensegan_torch.cli.common import (device_from_args, device_record,
                                         load_data, load_gan)
from defensegan_torch.configs import load_config
from defensegan_torch.defense.pipeline import DefendedPipeline
from defensegan_torch.eval.classifier import load_cached_classifier
from defensegan_torch.models import build_classifier
from defensegan_torch.utils.misc import (append_jsonl, ensure_dir,
                                         generator_for)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cfg", required=True,
                    help="YAML config or a trained run's output dir")
    ap.add_argument("--model", default="A")
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[1, 16, 256, 1024, 4096, 16384])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--kernel", default=None,
                    help="rec_kernel override per predict (default: the "
                    "config's PROJECTION_KERNEL)")
    ap.add_argument("--rec_rr", type=int, default=None,
                    help="restart-count override (e.g. 1: the fresh-z0 "
                    "R=1 / L=200 serving operating point)")
    ap.add_argument("--rec_iters", type=int, default=None)
    ap.add_argument("--rec_init", default=None,
                    choices=["random", "encoder", "encoder_jitter"],
                    help="projection z0 policy (default: the config's "
                    "REC_INIT); encoder*: the amortized-inversion init, "
                    "needs an encoder in the run's export")
    ap.add_argument("--sharded", action="store_true",
                    help="serve through ShardedDefenseGAN over every GPU "
                    "(on one card: its wrapper's overhead against the bare "
                    "DefenseGAN at equal batch)")
    ap.add_argument("--fpr", type=float, default=0.05)
    ap.add_argument("--detector", default="two_sided",
                    choices=["two_sided", "one_sided", "combined",
                             "combined3", "margin"])
    ap.add_argument("--calib_n", type=int, default=256)
    ap.add_argument("--detect_passes", type=int, default=1,
                    help="K-pass detection (K projection passes an input)")
    ap.add_argument("--clf_dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="classifier compute dtype (weights stay float32); "
                    "bfloat16 also prints its prediction disagreement with "
                    "float32 on the test head")
    ap.add_argument("--input_dtype", default="float32",
                    choices=["float32", "uint8"],
                    help="dtype of the images handed to predict(); uint8 is "
                    "the realistic serving ingest, normalized on the device")
    ap.add_argument("--results_dir", default="output/results_torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: the card; pass cpu "
                    "to run on the CPU)")
    return ap


def _classifier(args, cfg, device, dtype):
    model = build_classifier(args.model, num_classes=cfg.num_classes,
                             dtype=dtype, image_shape=cfg.image_shape
                             ).to(device)
    return load_cached_classifier(f"{cfg.type}_model{args.model}", model)


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    cfg = load_config(args.cfg)
    device = device_from_args(args)
    gan = load_gan(cfg, device, require_trained=True)
    serve_gan = gan
    if args.sharded:
        from defensegan_torch.parallel import ShardedDefenseGAN, make_mesh
        mesh = make_mesh() if device.type == "cuda" else \
            make_mesh(devices=[device])
        serve_gan = ShardedDefenseGAN(gan, mesh)
        print(f"serving through ShardedDefenseGAN over {len(mesh)} "
              "device(s)")
    ds = load_data(cfg)
    x_train_u8, _ = ds.load_u8("train")
    x_calib = np.asarray(x_train_u8[-args.calib_n:], np.float32) / 255.0
    x_test, _ = ds.load("test")

    tag = f"{cfg.type}_model{args.model}"
    clf_dtype = torch.bfloat16 if args.clf_dtype == "bfloat16" \
        else torch.float32
    clf = _classifier(args, cfg, device, clf_dtype)
    if clf is None:
        raise SystemExit(f"no cached classifier for {tag}: run the "
                         "matching whitebox_torch.py cell first (it trains "
                         "and caches it)")
    print(f"loaded classifier {tag} (compute dtype {args.clf_dtype})")
    clf_disagree = None
    if args.clf_dtype != "float32":
        clf32 = _classifier(args, cfg, device, torch.float32)
        head = torch.as_tensor(x_test[:1024], device=device)
        with torch.no_grad():
            p32 = clf32.logits_fn()(head).argmax(-1)
            p16 = clf.logits_fn()(head).argmax(-1)
        clf_disagree = float((p32 != p16).float().mean())
        print(f"clf bf16 vs f32 prediction disagreement on "
              f"{head.shape[0]} test images: {clf_disagree:.4f}")

    pipe = DefendedPipeline(serve_gan, clf.logits_fn(), fpr=args.fpr,
                            detector=args.detector, rec_rr=args.rec_rr,
                            rec_iters=args.rec_iters, rec_kernel=args.kernel,
                            rec_init=args.rec_init,
                            detect_passes=args.detect_passes)
    rr = args.rec_rr if args.rec_rr is not None else cfg.rec_rr
    iters = args.rec_iters if args.rec_iters is not None else cfg.rec_iters
    t0 = time.perf_counter()
    pipe.calibrate(x_calib, generator_for(101, device))
    print(f"calibrated {args.detector} detector on {args.calib_n} clean "
          f"images in {time.perf_counter() - t0:.1f}s "
          f"(center {pipe._center:.5f}, threshold {pipe._threshold:.5f})")

    ensure_dir(args.results_dir)
    out_path = os.path.join(args.results_dir, "serving_bench.jsonl")
    record = device_record(device)
    rows = []
    for b in args.batches:
        reps = int(np.ceil(b / x_test.shape[0]))
        x = np.tile(x_test, (reps,) + (1,) * (x_test.ndim - 1))[:b]
        if args.input_dtype == "uint8":
            x = np.round(x * 255.0).astype(np.uint8)
        pipe.predict(x, generator_for(0, device), batch_size=b)  # warm-up
        times, flag_rate = [], None
        for i in range(args.repeats):
            t0 = time.perf_counter()
            out = pipe.predict(x, generator_for(i + 1, device),
                               batch_size=b)
            times.append(time.perf_counter() - t0)
            flag_rate = float(np.mean(out.flagged))
        row = {
            "script": "serving_bench", "dataset": cfg.type,
            "model": args.model, "batch": b,
            "kernel": serve_gan.last_kernel, "rec_rr": rr,
            "rec_iters": iters,
            "rec_init": args.rec_init or cfg.rec_init,
            "detector": args.detector,
            "detect_passes": args.detect_passes,
            "latency_ms_min": round(min(times) * 1e3, 2),
            "latency_ms_median": round(float(np.median(times)) * 1e3, 2),
            "images_per_s": round(b / min(times), 2),
            "clean_flag_rate": flag_rate,
            "repeats": args.repeats,
            "sharded": bool(args.sharded),
            "clf_dtype": args.clf_dtype,
            "clf_bf16_disagree": clf_disagree,
            "input_dtype": args.input_dtype,
            "device": record,
            "package": "defensegan_torch",
        }
        rows.append(row)
        append_jsonl(out_path, row)
        print(json.dumps(row), flush=True)

    print(f"\n{'batch':>7} {'kernel':>12} {'lat ms (min)':>13} "
          f"{'img/s':>10}")
    for r in rows:
        print(f"{r['batch']:>7} {r['kernel']:>12} "
              f"{r['latency_ms_min']:>13.1f} {r['images_per_s']:>10.1f}")
    return rows


if __name__ == "__main__":
    main()
