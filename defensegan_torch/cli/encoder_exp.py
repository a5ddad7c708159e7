"""Encoder-init frontier: quality, robustness and throughput against
(R, L, init) (port of the JAX package's scripts/encoder_exp.py).

The amortized-inversion encoder (defense/encoder_init.py) claims the
projection can run at far smaller (R, L) from an encoder start without
giving up defense quality; this measures that claim as a grid of operating
points.

Legs:
  train      train the encoder for --cfg against the frozen generator
             (DefenseGAN.train_encoder: written into the run's weight
             export at the generator's step; run it on a copy of a run
             whose export must not change).
  frontier   per (R, L) x init cell, on --num_tests held-out test images:
             - clean defended accuracy (purify -> classifier), the pass
               run twice and the second timed -> recon_per_s;
             - FGSM(eps) through the defense: the exact gradient through
               the encoder and the unrolled projection of the same cell
               (attacks/compose.py::make_attack_target honours rec_init),
               crafted in --attack_batch chunks seeded by attack_batch_key;
             - detection at the cell: the rec-err two-sided AUC, the
               two-feature AUC and the joint undetected rate (in-sample
               clean calibration, as the white-box --detect rows).
The cell's clean pass draws from fold_seed(11, 0), its adversarial pass
from fold_seed(11, 1), the attack from attack_batch_key(23, lo) (the JAX
script's keys as integer seeds). The classifier comes from the cache
under output/classifiers_torch/<type>_model<M>, else it is trained (10
epochs, seed 7) and cached. Rows (the JAX script's keys plus `device`) go
to <results_dir>/encoder_exp.jsonl.

    python scripts/encoder_exp_torch.py --cfg output/gans/mnist_fast \\
        --model A --legs frontier --grid 10x200 2x50 1x25 \\
        --inits random encoder encoder_jitter
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from defensegan_torch.attacks.compose import (attack_batch_key,
                                              make_attack_target)
from defensegan_torch.attacks.fgsm import fgsm
from defensegan_torch.cli.common import (device_from_args, device_record,
                                         load_data, load_gan)
from defensegan_torch.configs import load_config
from defensegan_torch.eval.accuracy import model_eval
from defensegan_torch.eval.classifier import (ClassifierState,
                                              load_cached_classifier,
                                              save_classifier,
                                              train_classifier)
from defensegan_torch.eval.detect import (combined_scores,
                                          detection_features, roc_auc,
                                          two_sided_scores,
                                          undetected_success_rate)
from defensegan_torch.models import build_classifier
from defensegan_torch.utils.misc import (append_jsonl, ensure_dir,
                                         fold_seed, generator_for)

CELL_SEED, ATTACK_SEED, CLF_SEED, CLF_EPOCHS = 11, 23, 7, 10


class FrontierDraws(NamedTuple):
    """Given restart draws for every cell: features(pass, lo) -> z0 for the
    clean (pass 0) and the adversarial (pass 1) detection pass, attack(x,
    key) -> z0 for the attack target (make_attack_target's z0_fn)."""
    features: Callable[[int, int], torch.Tensor]
    attack: Callable[[torch.Tensor, int], torch.Tensor]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--model", default="A")
    ap.add_argument("--legs", nargs="+", default=["frontier"],
                    choices=["train", "frontier"])
    ap.add_argument("--grid", nargs="+",
                    default=["10x200", "4x100", "2x50", "1x25"],
                    help="RxL cells, e.g. 10x200 2x50")
    ap.add_argument("--inits", nargs="+",
                    default=["random", "encoder", "encoder_jitter"])
    ap.add_argument("--num_tests", type=int, default=256)
    ap.add_argument("--fgsm_eps", type=float, default=0.3)
    ap.add_argument("--attack_batch", type=int, default=128)
    ap.add_argument("--encoder_iters", type=int, default=None)
    ap.add_argument("--noise_aug", type=float, default=None,
                    help="override cfg ENCODER_NOISE_AUG for the train leg")
    ap.add_argument("--skip_attack", action="store_true",
                    help="frontier: clean quality + throughput only")
    ap.add_argument("--results_dir", default="output/results_torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: the card; pass cpu "
                    "to run on the CPU)")
    return ap


def get_or_train_classifier(cfg, model_name: str, x_train, y_train, device
                            ) -> ClassifierState:
    """The white-box CLI's cache layout: the cached classifier <type>_model
    <M>, else one trained (seed 7) and cached under that tag."""
    model = build_classifier(model_name, num_classes=cfg.num_classes,
                             image_shape=cfg.image_shape,
                             gen=torch.Generator().manual_seed(CLF_SEED)
                             ).to(device)
    tag = f"{cfg.type}_model{model_name}"
    cached = load_cached_classifier(tag, model)
    if cached is not None:
        print(f"loaded classifier {tag}")
        return cached
    print(f"training classifier {tag} ({CLF_EPOCHS} epochs)")
    state = train_classifier(model, x_train, y_train, seed=CLF_SEED,
                             epochs=CLF_EPOCHS)
    save_classifier(tag, state)
    return state


def train_leg(gan, x_train, encoder_iters: Optional[int],
              noise_aug: Optional[float]) -> dict:
    """Train the encoder (written into the run's export); the JAX row."""
    cfg = gan.cfg
    kw = {} if noise_aug is None else {"noise_aug": noise_aug}
    t0 = time.time()
    m = gan.train_encoder(x_train, iters=encoder_iters, **kw)
    return {"script": "encoder_exp", "leg": "train", "dataset": cfg.type,
            "iters": encoder_iters or cfg.encoder_train_iters,
            "noise_aug": (noise_aug if noise_aug is not None
                          else cfg.encoder_noise_aug),
            "beta_z": cfg.encoder_beta_z,
            "img_mse": round(float(m["img_mse"]), 6),
            "z_cycle": round(float(m["z_cycle"]), 5),
            "wall_s": round(time.time() - t0, 1),
            "gen_step": int(gan.step)}


def frontier_cell(gan, cfg, logits_fn, x_test, y_test, rr: int, iters: int,
                  init: str, *, model: str, clean_acc: float,
                  fgsm_eps: float, attack_batch: int, skip_attack: bool,
                  draws: Optional[FrontierDraws] = None):
    """One (R, L, init) cell: (the JAX row, the adversarial images or
    None)."""
    device = gan.device
    y_np = np.asarray(y_test)

    def feats(x, p):
        return detection_features(
            gan, x, logits_fn, gen=generator_for(fold_seed(CELL_SEED, p),
                                                 device),
            rec_rr=rr, rec_iters=iters, rec_init=init,
            z0_fn=None if draws is None
            else (lambda lo, p=p: draws.features(p, lo)))

    # clean pass (warm) + the timed second pass -> recon/s
    f_clean = feats(x_test, 0)
    t0 = time.time()
    f_clean = feats(x_test, 0)
    wall = time.time() - t0
    row = {"script": "encoder_exp", "leg": "frontier",
           "dataset": cfg.type, "model": model,
           "rec_rr": rr, "rec_iters": iters, "rec_init": init,
           "num_tests": int(x_test.shape[0]),
           "clean_acc": round(clean_acc, 4),
           "clean_defended_acc": round(float(np.mean(f_clean.preds
                                                     == y_np)), 4),
           "rec_err_clean_mean": round(float(np.mean(f_clean.errs)), 6),
           "margin_clean_mean": round(float(np.mean(f_clean.margins)), 3),
           "recon_per_s": round(x_test.shape[0] / wall, 1)}
    if skip_attack:
        return row, None

    # FGSM through the deployed cell (exact gradient, through the encoder
    # when init is encoder*)
    cfg_cell = cfg.replace(rec_rr=rr, rec_iters=iters, rec_init=init)
    target = make_attack_target(gan, logits_fn, cfg_cell,
                                z0_fn=draws.attack if draws else None)
    advs = []
    t0 = time.time()
    for lo in range(0, x_test.shape[0], attack_batch):
        hi = min(lo + attack_batch, x_test.shape[0])
        k = attack_batch_key(ATTACK_SEED, lo)
        xb = torch.as_tensor(x_test[lo:hi], device=device)
        yb = torch.as_tensor(y_np[lo:hi], device=device)
        advs.append(fgsm(lambda x, k=k: target(x, k), xb, yb,
                         fgsm_eps).cpu().numpy())
    x_adv = np.concatenate(advs)
    craft_s = time.time() - t0

    f_adv = feats(x_adv, 1)
    auc_2s = roc_auc(two_sided_scores(f_clean.errs, f_clean.errs),
                     two_sided_scores(f_adv.errs, f_clean.errs))
    s_clean = combined_scores(f_clean.errs, f_clean.margins,
                              f_clean.errs, f_clean.margins)
    s_adv = combined_scores(f_adv.errs, f_adv.margins,
                            f_clean.errs, f_clean.margins)
    joint_2f, _ = undetected_success_rate(s_clean, s_adv,
                                          f_adv.preds != y_np)
    row.update({
        "fgsm_eps": fgsm_eps,
        "adv_acc_no_defense": round(model_eval(logits_fn, x_adv, y_np), 4),
        "defended_acc": round(float(np.mean(f_adv.preds == y_np)), 4),
        "rec_err_adv_mean": round(float(np.mean(f_adv.errs)), 6),
        "detection_auc_two_sided": round(auc_2s, 4),
        "detection_auc_combined": round(roc_auc(s_clean, s_adv), 4),
        "undetected_success_combined": round(float(joint_2f), 4),
        "craft_s": round(craft_s, 1)})
    return row, x_adv


def summary_table(rows: list, skip_attack: bool) -> str:
    hdr = (f"{'R x L':>8} {'init':>15} {'clean-def':>9} {'recon/s':>8}"
           + ("" if skip_attack else
              f" {'fgsm-def':>8} {'AUC2f':>6} {'joint':>6}"))
    lines = [hdr]
    for r in rows:
        line = (f"{r['rec_rr']}x{r['rec_iters']:>4} {r['rec_init']:>15} "
                f"{r['clean_defended_acc']:>9.3f} {r['recon_per_s']:>8.1f}")
        if not skip_attack:
            line += (f" {r['defended_acc']:>8.3f} "
                     f"{r['detection_auc_combined']:>6.3f} "
                     f"{r['undetected_success_combined']:>6.3f}")
        lines.append(line)
    return "\n".join(lines)


def main(argv=None, draws: Optional[FrontierDraws] = None) -> dict:
    """Run the legs; returns {"train": row or None, "frontier": rows,
    "x_adv": {(R, L, init): images}} (draws: given restart draws, for the
    tests)."""
    args = build_parser().parse_args(argv)
    cfg = load_config(args.cfg)
    device = device_from_args(args)
    gan = load_gan(cfg, device, require_trained=True)
    ds = load_data(cfg)
    x_train, y_train = ds.load("train")
    x_test, y_test = ds.load("test")
    x_test, y_test = x_test[:args.num_tests], y_test[:args.num_tests]
    dev_rec = device_record(device)
    ensure_dir(args.results_dir)
    out_path = os.path.join(args.results_dir, "encoder_exp.jsonl")
    out = {"train": None, "frontier": [], "x_adv": {}}

    if "train" in args.legs:
        row = dict(train_leg(gan, x_train, args.encoder_iters,
                             args.noise_aug), device=dev_rec)
        append_jsonl(out_path, row)
        print(json.dumps(row), flush=True)
        out["train"] = row
    if "frontier" not in args.legs:
        return out

    clf = get_or_train_classifier(cfg, args.model, x_train, y_train, device)
    logits_fn = clf.logits_fn()
    clean_acc = model_eval(logits_fn, x_test, y_test)
    print(f"bare classifier clean acc: {clean_acc:.4f}")
    if any(i != "random" for i in args.inits) and not gan.has_encoder():
        raise SystemExit("no trained encoder: run the train leg first")

    for cell in args.grid:
        rr, iters = (int(v) for v in cell.split("x"))
        for init in args.inits:
            row, x_adv = frontier_cell(
                gan, cfg, logits_fn, x_test, y_test, rr, iters, init,
                model=args.model, clean_acc=clean_acc,
                fgsm_eps=args.fgsm_eps, attack_batch=args.attack_batch,
                skip_attack=args.skip_attack, draws=draws)
            row["device"] = dev_rec
            out["frontier"].append(row)
            out["x_adv"][(rr, iters, init)] = x_adv
            append_jsonl(out_path, row)
            print(json.dumps(row), flush=True)
    print("\n" + summary_table(out["frontier"], args.skip_attack))
    return out


if __name__ == "__main__":
    main()
