"""Serving-pipeline operational evaluation of the DefendedPipeline (port of
the JAX package's scripts/pipeline_exp.py).

Pushes white-box-crafted adversarial sets (whitebox --save_adv npz files:
x_clean, x_adv, y, meta) through the deployment object
defense/pipeline.py::DefendedPipeline, calibrated on held-out CLEAN data
only, and reports what an operator ships: per set, the flag rate, the
accuracy on unflagged inputs and the undetected-success rate
P(misclassified AND unflagged). The first set's clean images are
reported first, as the set `clean`.

Calibration sources (the JAX script's slices):
  test_tail   test images [eval_slice_n : eval_slice_n + calib_n], after
              the attack-eval slice at the head of the test set (refused
              when the test set lies wholly inside that slice);
  dev         dev images [:calib_n];
  train_tail  train images [-calib_n:] (the optimistic round-4 protocol,
              kept for comparison rows).
Calibration draws its restarts from seed 101, every set's prediction from
seed 202 (the JAX script's keys as integer seeds).

Needs the classifier cached under output/classifiers_torch/<type>_model<M>
(whitebox_torch.py trains and caches it). Writes one row per set to
<results_dir>/pipeline.jsonl: the JAX script's keys plus `device`.

    python scripts/pipeline_exp_torch.py --cfg output/gans/mnist_fast \\
        --model A --sets output/advsets/flagship_conf_l300.npz \\
        [--detector combined] [--calib_n 256] [--detect_passes 4 --vote]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import NamedTuple, Optional

import numpy as np

from defensegan_torch.cli.common import (cfg_from_args, device_from_args,
                                         device_record, load_data, load_gan)
from defensegan_torch.defense.pipeline import DefendedPipeline, Z0Fn
from defensegan_torch.eval.classifier import load_cached_classifier
from defensegan_torch.models import build_classifier
from defensegan_torch.utils.misc import (append_jsonl, ensure_dir,
                                         generator_for)

CALIB_SEED, PREDICT_SEED = 101, 202


class PipelineDraws(NamedTuple):
    """Given restart draws (DefendedPipeline's z0_fn(pass, lo)) for the
    calibration and for every set's prediction: an exact replay of
    another package's draws."""
    calibrate: Z0Fn
    predict: Z0Fn


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cfg", required=True,
                    help="YAML config or a trained run's output dir")
    ap.add_argument("--model", default="A")
    ap.add_argument("--sets", nargs="+", required=True,
                    help="npz files from whitebox --save_adv")
    ap.add_argument("--fpr", type=float, default=0.05)
    ap.add_argument("--detector", default="two_sided",
                    choices=["two_sided", "one_sided", "combined",
                             "combined3", "margin"])
    ap.add_argument("--calib_n", type=int, default=256)
    ap.add_argument("--detect_passes", type=int, default=1,
                    help="K-pass detection: average the detector features "
                    "over K projection passes (K passes an input)")
    ap.add_argument("--vote", action="store_true",
                    help="K-pass majority-vote prediction (needs "
                    "--detect_passes >= 2)")
    ap.add_argument("--calib_source", default="test_tail",
                    choices=["test_tail", "train_tail", "dev"],
                    help="test_tail (default): clean test images after the "
                    "attack-eval slice; dev: the dev split; train_tail: the "
                    "last train images (optimistic margins, for comparison "
                    "rows)")
    ap.add_argument("--eval_slice_n", type=int, default=256,
                    help="size of the attack-eval slice at the head of the "
                    "test set (test_tail calibration starts after it)")
    ap.add_argument("--override", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="config overrides (any UPPERCASE YAML key), e.g. "
                    "REC_RR=2 REC_ITERS=50 REC_INIT=encoder for the "
                    "amortized serving operating point")
    ap.add_argument("--results_dir", default="output/results_torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: the card; pass cpu "
                    "to run on the CPU)")
    return ap


def calibration_set(ds, source: str, calib_n: int, eval_slice_n: int):
    """(x_calib, (split, lo, hi)): the clean calibration images of
    `source` and the slice of its split they are (the JAX script's
    slices, Python's slice semantics included)."""
    if source == "train_tail":
        split, sl = "train", slice(-calib_n, None)
    elif source == "dev":
        split, sl = "dev", slice(None, calib_n)
    else:
        split, sl = "test", slice(eval_slice_n, eval_slice_n + calib_n)
    x, _ = ds.load(split)
    if source == "test_tail" and x.shape[0] <= eval_slice_n:
        raise SystemExit(
            f"test set has {x.shape[0]} images, all inside the "
            f"attack-eval slice ({eval_slice_n}): no held-out test "
            "images to calibrate on; use --calib_source train_tail or "
            "dev, or shrink --eval_slice_n")
    lo, hi, _ = sl.indices(x.shape[0])
    return x[sl], (split, lo, hi)


def main(argv=None, draws: Optional[PipelineDraws] = None) -> list:
    """Run the evaluation; returns the rows as written (draws: given
    restart draws, for the tests)."""
    args = build_parser().parse_args(argv)
    cfg = cfg_from_args(args)
    device = device_from_args(args)
    gan = load_gan(cfg, device, require_trained=True)
    ds = load_data(cfg)

    tag = f"{cfg.type}_model{args.model}"
    model = build_classifier(args.model, num_classes=cfg.num_classes,
                             image_shape=cfg.image_shape).to(device)
    clf = load_cached_classifier(tag, model)
    if clf is None:
        raise SystemExit(f"no cached classifier for {tag}: run the "
                         "matching whitebox_torch.py cell first (it trains "
                         "and caches it)")
    print(f"loaded classifier {tag}")

    x_calib, (split, lo, hi) = calibration_set(
        ds, args.calib_source, args.calib_n, args.eval_slice_n)
    pipe = DefendedPipeline(gan, clf.logits_fn(), fpr=args.fpr,
                            detector=args.detector,
                            detect_passes=args.detect_passes,
                            vote=args.vote)
    pipe.calibrate(x_calib, gen=generator_for(CALIB_SEED, device),
                   z0_fn=draws.calibrate if draws else None)
    print(f"calibrated {args.detector} detector on {len(x_calib)} clean "
          f"{args.calib_source} images ({split}[{lo}:{hi}]) @ "
          f"{args.fpr:.0%} FPR (center {pipe._center:.5f}, threshold "
          f"{pipe._threshold:.5f}); projection ran {gan.last_kernel}")

    ensure_dir(args.results_dir)
    out_path = os.path.join(args.results_dir, "pipeline.jsonl")
    dev_rec = device_record(device)

    def report(name, x, y, meta=None):
        out = pipe.predict(x, gen=generator_for(PREDICT_SEED, device),
                           z0_fn=draws.predict if draws else None)
        correct = out.pred == y
        unflagged = ~out.flagged
        row = {
            "script": "pipeline_exp", "dataset": cfg.type,
            "model": args.model, "set": name,
            "detector": args.detector, "fpr": args.fpr,
            "calib_n": int(len(x_calib)),
            "calib_source": args.calib_source, "n": int(len(y)),
            "detect_passes": args.detect_passes,
            "vote": args.vote,
            "rec_rr": cfg.rec_rr, "rec_iters": cfg.rec_iters,
            "rec_init": cfg.rec_init,
            "flag_rate": float(out.flagged.mean()),
            "acc_all": float(correct.mean()),
            "acc_unflagged": (float(correct[unflagged].mean())
                              if unflagged.any() else None),
            "undetected_success_rate": float((~correct & unflagged).mean()),
            "rec_err_mean": float(out.rec_err.mean()),
            "margin_mean": float(out.margin.mean()),
            "meta": meta,
            "device": dev_rec,
        }
        append_jsonl(out_path, row)
        print(json.dumps(row), flush=True)
        return row

    with np.load(args.sets[0], allow_pickle=False) as first:
        rows = [report("clean", first["x_clean"], first["y"])]
    for path in args.sets:
        with np.load(path, allow_pickle=False) as d:
            meta = json.loads(str(d["meta"]))
            name = os.path.splitext(os.path.basename(path))[0]
            rows.append(report(name, d["x_adv"], d["y"], meta))
    return rows


if __name__ == "__main__":
    main()
