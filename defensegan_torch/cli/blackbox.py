"""Black-box attack + defense evaluation CLI (port of the JAX package's
cli/blackbox.py).

Reference parity: blackbox.py of kabkabm/defensegan, the cleverhans
mnist_blackbox recipe:
  python blackbox_torch.py --cfg <dir-or-yml> --bb_model A --sub_model B
      [--fgsm_eps 0.3] [--data_aug 6] [--lmbda 0.1] [--num_tests N]
      [--defense_type {none,defense_gan,adv_tr}] [--device cpu]

prep_bbox (train the black-box target) -> train_sub (Jacobian-augmentation
substitute, seeded with the first 150 test images, as in the paper) ->
FGSM on the substitute -> transfer to the target on the next num_tests
test images, with and without Defense-GAN purification. The defended
evaluation and --detect run gan.reconstruct, which resolves to the fused
CUDA loop on the card (v2 on the flagship; `last_kernel` in the row).

Runs on the card unless --device names another device. The results row
has the JAX CLI's keys plus `device` (name and power limit), `package`
and `last_kernel`, and goes to output/results_torch/blackbox.jsonl.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from defensegan_torch.attacks import fgsm, train_substitute
from defensegan_torch.cli.common import (add_cfg_args, cfg_from_args,
                                         device_from_args, device_record,
                                         limit, load_data, load_gan)
from defensegan_torch.eval.accuracy import model_eval, model_eval_gan
from defensegan_torch.eval.classifier import train_classifier
from defensegan_torch.eval.detect import (combined_scores,
                                          detection_features, roc_auc,
                                          tpr_at_fpr, two_sided_scores,
                                          undetected_success_rate)
from defensegan_torch.models import build_classifier
from defensegan_torch.utils.misc import (append_jsonl, ensure_dir,
                                         fold_seed, generator_for)
from defensegan_torch.utils.profiling import PhaseTimer

HOLDOUT = 150  # substitute seed size (paper / cleverhans tutorial)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    add_cfg_args(ap)
    ap.add_argument("--bb_model", default="A", help="black-box target A..F")
    ap.add_argument("--sub_model", default="B", help="substitute A..F")
    ap.add_argument("--defense_type", default="defense_gan",
                    choices=["none", "defense_gan", "adv_tr"],
                    help="adv_tr: the target is FGSM-adversarially trained "
                    "(the reference's adversarial-training baseline), no "
                    "purification")
    ap.add_argument("--fgsm_eps", type=float, default=0.3)
    ap.add_argument("--data_aug", type=int, default=6,
                    help="Jacobian augmentation rounds (rho)")
    ap.add_argument("--lmbda", type=float, default=0.1)
    ap.add_argument("--num_tests", type=int, default=512)
    ap.add_argument("--classifier_epochs", type=int, default=10)
    ap.add_argument("--sub_epochs", type=int, default=10)
    ap.add_argument("--sub_from_scratch", action="store_true",
                    help="ablation: re-initialize the substitute every "
                    "augmentation round (the reference keeps training the "
                    "same one, the default here)")
    ap.add_argument("--train_on_recs", action="store_true",
                    help="train the target on Defense-GAN reconstructions "
                    "of the training set (reference --train_on_recs)")
    ap.add_argument("--num_rec_train", type=int, default=1024)
    ap.add_argument("--detect", action="store_true",
                    help="also report transfer-attack DETECTION by "
                    "reconstruction error (the statistics of whitebox "
                    "--detect; needs --defense_type defense_gan)")
    ap.add_argument("--detect_save", default=None, metavar="PATH.npz",
                    help="with --detect: save the per-example paired "
                    "detection statistics (the JAX CLI's npz layout)")
    ap.add_argument("--results_dir", default="output/results_torch")
    return ap


def _predict(logits_fn, x: np.ndarray, batch_size: int = 256) -> np.ndarray:
    out = []
    with torch.no_grad():
        for i in range(0, x.shape[0], batch_size):
            out.append(torch.argmax(logits_fn(torch.as_tensor(
                x[i:i + batch_size])), dim=-1).cpu().numpy())
    return np.concatenate(out)


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.detect and args.defense_type != "defense_gan":
        ap.error("--detect scores inputs with the GAN projection loss: it "
                 "needs --defense_type defense_gan")
    if args.detect_save and not args.detect:
        ap.error("--detect_save stores the --detect statistics; add "
                 "--detect")
    cfg = cfg_from_args(args)
    device = device_from_args(args)

    ds = load_data(cfg)
    x_train, y_train = ds.load("train")
    x_test, y_test = ds.load("test")
    # paper protocol: the first HOLDOUT test images seed the substitute;
    # the attack is evaluated on the num_tests images after them
    x_seed = x_test[:HOLDOUT]
    x_eval, y_eval = limit(x_test[HOLDOUT:], y_test[HOLDOUT:],
                           args.num_tests)

    base = cfg.seed + 13
    k_bb, k_sub, k_eval = (fold_seed(base, i) for i in range(3))
    gan = None
    if args.defense_type == "defense_gan" or args.train_on_recs:
        gan = load_gan(cfg, device, require_trained=True)

    def classifier(name: str, seed: int):
        return build_classifier(name, num_classes=cfg.num_classes,
                                image_shape=cfg.image_shape,
                                gen=torch.Generator().manual_seed(seed)
                                ).to(device)

    timer = PhaseTimer(device)
    kernels = {}
    # --- prep_bbox: train the black-box target
    x_fit, y_fit = x_train, y_train
    if args.train_on_recs:
        n = min(args.num_rec_train, x_train.shape[0])
        print(f"reconstructing {n} training images for --train_on_recs ...")
        recs = []
        with timer.phase("reconstruct_train"):
            for i in range(0, n, 256):
                res = gan.reconstruct(x_train[i:i + 256],
                                      generator_for(fold_seed(k_bb, i),
                                                    device))
                recs.append(res.x_hat.float().cpu().numpy())
        kernels["reconstruct_train"] = gan.last_kernel
        x_fit, y_fit = np.concatenate(recs)[:n], y_train[:n]
    adv_eps = args.fgsm_eps if args.defense_type == "adv_tr" else None
    print(f"training black-box target model {args.bb_model}"
          + (f" (FGSM adv training eps={adv_eps})" if adv_eps else "")
          + " ...")
    with timer.phase("train_target"):
        bb = train_classifier(classifier(args.bb_model, k_bb), x_fit, y_fit,
                              seed=k_bb, epochs=args.classifier_epochs,
                              adv_eps=adv_eps, quiet=False)
    bb_logits = bb.logits_fn()
    clean_acc = model_eval(bb_logits, x_eval, y_eval)
    print(f"target clean accuracy: {clean_acc:.4f}")

    # --- train_sub: Jacobian-augmentation substitute (oracle = target)
    print(f"training substitute model {args.sub_model} "
          f"({args.data_aug} augmentation rounds) ...")
    with timer.phase("train_substitute"):
        sub, x_sub = train_substitute(
            lambda s: classifier(args.sub_model, s), bb_logits, x_seed,
            seed=k_sub, data_aug=args.data_aug, lmbda=args.lmbda,
            epochs_per_round=args.sub_epochs,
            persistent=not args.sub_from_scratch, quiet=False)
    sub_logits = sub.logits_fn()
    agree = model_eval(sub_logits, x_eval, _predict(bb_logits, x_eval))
    print(f"substitute agreement with target: {agree:.4f} "
          f"(final sub set {x_sub.shape[0]})")

    # --- FGSM on the substitute, transferred to the target
    with timer.phase("attack"):
        advs = []
        for i in range(0, x_eval.shape[0], 256):
            xb = torch.as_tensor(x_eval[i:i + 256], device=device)
            yb = torch.as_tensor(y_eval[i:i + 256].astype(np.int64),
                                 device=device)
            advs.append(fgsm(sub_logits, xb, yb, args.fgsm_eps)
                        .cpu().numpy())
        x_adv = np.concatenate(advs)
    adv_acc = model_eval(bb_logits, x_adv, y_eval)
    print(f"target accuracy under transferred FGSM (eps={args.fgsm_eps}), "
          f"NO defense: {adv_acc:.4f}")

    defended_acc = clean_defended_acc = defended_correct_adv = None
    if args.defense_type == "adv_tr":
        defended_acc = adv_acc  # the defense is in the classifier weights
    if args.defense_type == "defense_gan":
        with timer.phase("purify_classify_clean"):
            clean_defended_acc = model_eval_gan(
                gan, bb_logits, x_eval, y_eval,
                gen=generator_for(k_eval, device))
        kernels["purify_classify_clean"] = gan.last_kernel
        print(f"target accuracy on purified CLEAN inputs: "
              f"{clean_defended_acc:.4f} [{gan.last_kernel}]")
        with timer.phase("purify_classify_adv"):
            defended_acc, defended_correct_adv = model_eval_gan(
                gan, bb_logits, x_adv, y_eval,
                gen=generator_for(k_eval, device), return_correct=True)
        kernels["purify_classify_adv"] = gan.last_kernel
        print(f"target accuracy under FGSM, Defense-GAN (R={cfg.rec_rr}, "
              f"L={cfg.rec_iters}): {defended_acc:.4f} [{gan.last_kernel}]")

    det = {}
    if args.detect:
        det = run_detection(args, cfg, gan, bb_logits, x_eval, x_adv,
                            k_eval, defended_correct_adv, timer, device)
        kernels["detect"] = gan.last_kernel

    ensure_dir(args.results_dir)
    record = {
        "script": "blackbox", "dataset": cfg.type,
        "bb_model": args.bb_model, "sub_model": args.sub_model,
        "defense": args.defense_type, "fgsm_eps": args.fgsm_eps,
        "data_aug": args.data_aug, "lmbda": args.lmbda,
        "train_on_recs": args.train_on_recs,
        "sub_from_scratch": args.sub_from_scratch,
        "num_tests": int(x_eval.shape[0]),
        "clean_acc": clean_acc, "sub_agreement": agree,
        "clean_defended_acc": clean_defended_acc,
        "adv_acc_no_defense": adv_acc, "defended_acc": defended_acc,
        "detection_auc": det.get("auc"),
        "detection_tpr_at_fpr05": det.get("tpr"),
        "detection_auc_two_sided": det.get("auc_2s"),
        "detection_tpr_at_fpr05_two_sided": det.get("tpr_2s"),
        "detection_auc_combined": det.get("auc_comb"),
        "detection_tpr_at_fpr05_combined": det.get("tpr_comb"),
        "undetected_success_rate": det.get("us"),
        "undetected_success_rate_two_sided": det.get("us_2s"),
        "undetected_success_rate_combined": det.get("us_comb"),
        "rec_err_clean_mean": det.get("rec_err_clean"),
        "rec_err_adv_mean": det.get("rec_err_adv"),
        "phases": timer.summary(),
        "last_kernel": kernels, "device": device_record(device),
        "package": "defensegan_torch",
    }
    print(f"phase breakdown: {timer}")
    append_jsonl(os.path.join(args.results_dir, "blackbox.jsonl"), record)
    print(json.dumps(record))
    return record


def run_detection(args, cfg, gan, logits_fn, x_eval, x_adv, k_eval,
                  defended_correct_adv, timer, device) -> dict:
    """Transfer-attack detection by reconstruction error (whitebox
    --detect's statistics): the clean and adversarial passes share their
    restart seeds, and the purified margins come from the TARGET, the
    defender's own model."""
    with timer.phase("detect"):
        k_det = fold_seed(k_eval, 555)
        fc = detection_features(gan, x_eval, logits_fn,
                                gen=generator_for(k_det, device))
        fa = detection_features(gan, x_adv, logits_fn,
                                gen=generator_for(k_det, device))
    d = {"auc": roc_auc(fc.errs, fa.errs)}
    d["tpr"], _ = tpr_at_fpr(fc.errs, fa.errs, 0.05)
    d["rec_err_clean"] = float(fc.errs.mean())
    d["rec_err_adv"] = float(fa.errs.mean())
    s_clean_2s = two_sided_scores(fc.errs, fc.errs)
    s_adv_2s = two_sided_scores(fa.errs, fc.errs)
    d["auc_2s"] = roc_auc(s_clean_2s, s_adv_2s)
    d["tpr_2s"], _ = tpr_at_fpr(s_clean_2s, s_adv_2s, 0.05)
    s_clean_comb = combined_scores(fc.errs, fc.margins, fc.errs, fc.margins)
    s_adv_comb = combined_scores(fa.errs, fa.margins, fc.errs, fc.margins)
    d["auc_comb"] = roc_auc(s_clean_comb, s_adv_comb)
    d["tpr_comb"], _ = tpr_at_fpr(s_clean_comb, s_adv_comb, 0.05)
    missed = ~defended_correct_adv
    d["us"], _ = undetected_success_rate(fc.errs, fa.errs, missed)
    d["us_2s"], _ = undetected_success_rate(s_clean_2s, s_adv_2s, missed)
    d["us_comb"], _ = undetected_success_rate(s_clean_comb, s_adv_comb,
                                              missed)
    print(f"transfer-attack detection by rec error: AUC {d['auc']:.4f} "
          f"(two-sided {d['auc_2s']:.4f}, two-feature {d['auc_comb']:.4f}),"
          f" detection rate {d['tpr']:.4f} @ 5% FPR; undetected successful "
          f"attacks {d['us']:.4f} one-sided / {d['us_2s']:.4f} two-sided / "
          f"{d['us_comb']:.4f} two-feature")
    if args.detect_save:
        ensure_dir(os.path.dirname(args.detect_save) or ".")
        meta = {"dataset": cfg.type, "script": "blackbox",
                "bb_model": args.bb_model, "sub_model": args.sub_model,
                "attack": "fgsm_transfer", "defense": args.defense_type,
                "fgsm_eps": args.fgsm_eps, "data_aug": args.data_aug,
                "lmbda": args.lmbda, "rec_rr": cfg.rec_rr,
                "rec_iters": cfg.rec_iters, "package": "defensegan_torch"}
        np.savez(args.detect_save, errs_clean=fc.errs, errs_adv=fa.errs,
                 margins_clean=fc.margins, margins_adv=fa.margins,
                 all_losses_clean=fc.all_losses,
                 all_losses_adv=fa.all_losses,
                 defended_correct_adv=np.asarray(defended_correct_adv,
                                                 bool),
                 meta=json.dumps(meta))
        print(f"saved per-example detection statistics to "
              f"{args.detect_save}")
    return d


if __name__ == "__main__":
    main()
