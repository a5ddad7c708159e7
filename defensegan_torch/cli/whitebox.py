"""White-box attack + defense evaluation CLI (port of the JAX package's
cli/whitebox.py).

Reference parity: whitebox.py of kabkabm/defensegan:
  python whitebox_torch.py --cfg <dir-or-yml> --attack_type
      {fgsm,rand_fgsm,cw,pgd,spsa,none} --defense_type
      {none,defense_gan,adv_tr} --model {A..F} [--num_tests N]
      [--train_on_recs] [--fgsm_eps 0.3] [--device cpu]

Pipeline: load the trained GAN -> train (or load the cached) classifier ->
craft the attack (through the differentiable reconstruction when
defending: back_prop=True on the generic path, or BPDA) -> purify ->
classify -> report clean / adversarial / defended accuracy and, with
--detect, detection by reconstruction error. The defended evaluation,
the detector and SPSA's queries run gan.reconstruct, which resolves to
the fused CUDA loop on the card (v2 on the flagship, `last_kernel` in the
record).

Runs on the card unless --device names another device. The results row
has the JAX CLI's keys plus `device` (name and power limit) and
`package`, and goes to output/results_torch/whitebox.jsonl; classifiers
are cached under output/classifiers_torch/<tag>/. --save_images and
--save_adv_pngs write PNGs as the JAX CLI does (utils/visualize.py).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from defensegan_torch.attacks import (CWConfig, attack_batch_key,
                                      attack_z0_key, carlini_wagner_l2,
                                      confident_margin_loss,
                                      effective_cw_chunk, eot_over_keys,
                                      fgsm, fold_seed, make_attack_loss,
                                      make_attack_target, make_chunked_cw,
                                      make_chunked_pgd, make_spsa,
                                      margin_loss, pgd, rand_fgsm,
                                      split_rand_fgsm_key)
from defensegan_torch.attacks.compose import generator_for
from defensegan_torch.cli.common import (add_cfg_args, cfg_from_args,
                                         device_from_args, device_record,
                                         limit, load_data, load_gan)
from defensegan_torch.defense.project import sample_z0
from defensegan_torch.eval.accuracy import model_eval, model_eval_gan
from defensegan_torch.eval.classifier import (load_cached_classifier,
                                              save_classifier,
                                              train_classifier)
from defensegan_torch.eval.detect import (combined_scores,
                                          detection_features, roc_auc,
                                          tpr_at_fpr, two_sided_scores,
                                          undetected_success_rate)
from defensegan_torch.models import build_classifier
from defensegan_torch.utils.misc import append_jsonl, ensure_dir
from defensegan_torch.utils.profiling import PhaseTimer
from defensegan_torch.utils.visualize import save_images, save_images_files


def get_classifier(cfg, args, gan, x_train, y_train, seed, device):
    """Train (or load the cached) classifier; --train_on_recs and adv_tr
    as in the reference."""
    model = build_classifier(args.model, num_classes=cfg.num_classes,
                             image_shape=cfg.image_shape,
                             gen=torch.Generator().manual_seed(seed)
                             ).to(device)
    tag = f"{cfg.type}_model{args.model}"
    if args.defense_type == "adv_tr":
        tag += f"_advtr{args.fgsm_eps}"
    if args.train_on_recs:
        tag += "_on_recs"

    if not args.retrain_classifier:
        cached = load_cached_classifier(tag, model)
        if cached is not None:
            print(f"loaded classifier {tag}")
            return cached

    x_fit, y_fit = x_train, y_train
    if args.train_on_recs:
        n = min(args.num_rec_train, x_train.shape[0])
        print(f"reconstructing {n} training images for --train_on_recs ...")
        recs = []
        for i in range(0, n, 256):
            res = gan.reconstruct(x_train[i:i + 256],
                                  generator_for(fold_seed(seed, i), device))
            recs.append(res.x_hat.float().cpu().numpy())
        x_fit = np.concatenate(recs)[:n]
        y_fit = y_train[:n]

    adv_eps = args.fgsm_eps if args.defense_type == "adv_tr" else None
    print(f"training classifier {tag} on {x_fit.shape[0]} images "
          f"({args.classifier_epochs} epochs"
          + (f", FGSM adv training eps={adv_eps}" if adv_eps else "") + ")")
    state = train_classifier(model, x_fit, y_fit, seed=seed,
                             epochs=args.classifier_epochs,
                             adv_eps=adv_eps, quiet=False)
    save_classifier(tag, state)
    return state


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    add_cfg_args(ap)
    ap.add_argument("--attack_type", default="fgsm",
                    choices=["fgsm", "rand_fgsm", "cw", "pgd", "spsa",
                             "none"],
                    help="fgsm/rand_fgsm/cw: the reference's suite; pgd: "
                    "Madry et al. (with --attack_grad bpda the Athalye et "
                    "al. adaptive attack); spsa: gradient-free, attacks the "
                    "deployed inference path (the fused kernels) directly")
    ap.add_argument("--defense_type", default="defense_gan",
                    choices=["none", "defense_gan", "adv_tr"])
    ap.add_argument("--model", default="A", help="classifier A..F")
    ap.add_argument("--num_tests", type=int, default=512)
    ap.add_argument("--fgsm_eps", type=float, default=0.3)
    ap.add_argument("--alpha", type=float, default=0.05,
                    help="RAND+FGSM random-step size")
    ap.add_argument("--cw_max_iterations", type=int, default=100)
    ap.add_argument("--cw_binary_search_steps", type=int, default=4)
    ap.add_argument("--cw_abort_early", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="cleverhans abort_early: stop a binary-search step "
                    "when the objective plateaus (checked at chunk "
                    "boundaries; implies the chunked CW loop)")
    ap.add_argument("--cw_chunk_iters", type=int, default=0,
                    help="run the CW inner loop in chunks of this many "
                    "iterations, printing progress between them (0 = "
                    "auto: 100 when attacking through the defense or "
                    "with --cw_abort_early; -1 = one chunk)")
    ap.add_argument("--pgd_iters", type=int, default=40,
                    help="PGD steps (Madry et al. MNIST setting: 40)")
    ap.add_argument("--pgd_eps_iter", type=float, default=0.01,
                    help="PGD per-step size; the ball radius is --fgsm_eps")
    ap.add_argument("--pgd_rand_init",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="uniform random start inside the eps ball")
    ap.add_argument("--pgd_z0", default="per_step",
                    choices=["per_step", "fixed"],
                    help="restart seeds of the through-defense PGD target: "
                    "per_step draws fresh z0 every step (EOT-style); fixed "
                    "pins one draw, which --eval_z0 both can replay")
    ap.add_argument("--pgd_rec_penalty", type=float, default=0.0,
                    help="detection-aware PGD: subtract this times the "
                    "projection loss (the --detect statistic) from the "
                    "objective (needs --attack_through_defense yes and "
                    "--defense_type defense_gan)")
    ap.add_argument("--pgd_rec_center", type=float, default=None,
                    metavar="C",
                    help="with --pgd_rec_penalty: penalize (rec_loss - C)^2 "
                    "instead of rec_loss (the counter to the two-sided "
                    "detector)")
    ap.add_argument("--pgd_chunk_iters", type=int, default=0,
                    help="report PGD progress every this many steps (0 = "
                    "auto: 5 exact / 20 bpda through the defense, none on "
                    "the bare classifier; -1 = none)")
    ap.add_argument("--spsa_iters", type=int, default=40,
                    help="SPSA Adam steps")
    ap.add_argument("--spsa_samples", type=int, default=32,
                    help="Rademacher pairs per SPSA gradient estimate")
    ap.add_argument("--spsa_delta", type=float, default=0.01,
                    help="SPSA finite-difference probe radius")
    ap.add_argument("--spsa_lr", type=float, default=0.01,
                    help="SPSA Adam learning rate on the perturbation")
    ap.add_argument("--spsa_chunk", type=int, default=8,
                    help="probe pairs per defended forward: each purifies "
                    "spsa_chunk * attack_batch images per sign")
    ap.add_argument("--spsa_rec_penalty", type=float, default=0.0,
                    metavar="LAMBDA",
                    help="detection-aware SPSA: subtract LAMBDA * rec_loss "
                    "(the projection's own final loss) from the objective")
    ap.add_argument("--spsa_rec_center", type=float, default=None,
                    metavar="C",
                    help="with --spsa_rec_penalty: penalize |rec_loss - C| "
                    "instead of rec_loss")
    ap.add_argument("--spsa_center_quantiles", type=float, nargs=2,
                    default=None, metavar=("LO", "HI"),
                    help="with --spsa_rec_penalty: per-image centers at "
                    "clean rec-err quantiles u ~ U[LO, HI] (measured on "
                    "one clean projection pass) instead of one "
                    "--spsa_rec_center")
    ap.add_argument("--spsa_objective", default="margin",
                    choices=["margin", "confident"],
                    help="margin: max_{i!=y} z_i - z_y on the defended "
                    "logits; confident: z_w - max_{j!=w} z_j with w the "
                    "best wrong class (requires --spsa_margin_kappa)")
    ap.add_argument("--spsa_margin_kappa", type=float, default=None,
                    metavar="KAPPA",
                    help="with --spsa_objective confident: the purified "
                    "margin level the attacker aims above")
    ap.add_argument("--train_on_recs", action="store_true")
    ap.add_argument("--online_training", action="store_true",
                    help="alias of --train_on_recs (reference CLI parity)")
    ap.add_argument("--num_rec_train", type=int, default=1024)
    ap.add_argument("--classifier_epochs", type=int, default=10)
    ap.add_argument("--retrain_classifier", action="store_true")
    ap.add_argument("--attack_batch", type=int, default=64)
    ap.add_argument("--attack_rec_iters", type=int, default=None,
                    help="L inside the attack graph (default cfg.rec_iters)")
    ap.add_argument("--attack_grad", default="exact",
                    choices=["exact", "bpda"],
                    help="exact: differentiate the unrolled L-step "
                    "projection (the reference); bpda: straight-through "
                    "identity around the real projection")
    ap.add_argument("--attack_through_defense", default="yes",
                    choices=["yes", "no"],
                    help="yes: the attacker differentiates through the "
                    "reconstruction; no: attack the bare classifier, "
                    "defense applied only at eval")
    ap.add_argument("--attack_eot_keys", type=int, default=1,
                    help="differentiate through the mean defended logits "
                    "over K projection seeds (EOT over the restart draw); "
                    "gradient attacks through the defense only")
    ap.add_argument("--eval_z0", default="fresh", choices=["fresh", "both"],
                    help="fresh: every defended eval batch draws new "
                    "restarts; both: also report defended accuracy with "
                    "the attack graph's own per-batch z0 "
                    "(defended_acc_attack_z0)")
    ap.add_argument("--detect", action="store_true",
                    help="also report detection by reconstruction error: "
                    "ROC AUC clean vs adversarial, detection rate at 5%% "
                    "FPR, the two-sided and two-feature variants, and the "
                    "joint undetected-success rate")
    ap.add_argument("--results_dir", default="output/results_torch")
    ap.add_argument("--save_adv", default=None, metavar="PATH.npz",
                    help="save the crafted set (x_adv, y, x_clean, meta)")
    ap.add_argument("--save_adv_pngs", action="store_true",
                    help="with --save_adv: also write every original and "
                    "adversarial image as its own PNG beside the npz "
                    "(<PATH>_pngs/)")
    ap.add_argument("--save_images", action="store_true",
                    help="write an original | adversarial | purified grid "
                    "of the first 16 images, and each of them as its own "
                    "PNG, into results_dir (with --defense_type "
                    "defense_gan)")
    ap.add_argument("--load_adv", default=None, metavar="PATH.npz",
                    help="replay a saved adversarial set (--save_adv "
                    "output, of either package) instead of crafting; "
                    "requires --attack_type none")
    ap.add_argument("--detect_passes", type=int, default=1, metavar="K",
                    help="with --detect: average the detection features "
                    "over K projection passes (clean/adv paired per pass)")
    ap.add_argument("--detect_save", default=None, metavar="PATH.npz",
                    help="with --detect: save the per-example paired "
                    "detection statistics")
    return ap


def check_args(ap: argparse.ArgumentParser, args) -> None:
    """The JAX CLI's flag rules, raised at parse time."""
    if (args.attack_type == "cw" and args.cw_abort_early
            and args.cw_chunk_iters < 0):
        ap.error("--cw_abort_early requires the chunked CW loop; drop "
                 "--cw_chunk_iters -1 (0 = auto-chunk) or the abort flag")
    if args.attack_type == "rand_fgsm" and args.alpha >= args.fgsm_eps:
        ap.error(f"--alpha ({args.alpha}) must be < --fgsm_eps "
                 f"({args.fgsm_eps}) for rand_fgsm (the FGSM step is "
                 f"eps - alpha)")
    if args.eval_z0 == "both" and (args.defense_type != "defense_gan"
                                   or args.attack_type == "none"
                                   or args.attack_through_defense != "yes"):
        ap.error("--eval_z0 both replays the attack graph's z0, so it "
                 "requires --defense_type defense_gan, an attack, and "
                 "--attack_through_defense yes")
    if (args.eval_z0 == "both" and args.attack_type == "pgd"
            and args.pgd_z0 == "per_step"):
        ap.error("--eval_z0 both needs a single attack z0 to replay, but "
                 "--pgd_z0 per_step draws fresh z0 every PGD step; use "
                 "--pgd_z0 fixed for the replay leg")
    if args.eval_z0 == "both" and args.attack_type == "spsa":
        ap.error("--eval_z0 both needs a single attack z0 to replay, but "
                 "spsa draws fresh defense seeds per (iteration, probe "
                 "chunk)")
    if args.attack_grad == "bpda" and args.attack_type == "spsa":
        ap.error("spsa is gradient-free: --attack_grad bpda has no "
                 "effect; drop the flag")
    if args.attack_eot_keys > 1:
        if (args.defense_type != "defense_gan"
                or args.attack_through_defense != "yes"
                or args.attack_type in ("none", "spsa")):
            ap.error("--attack_eot_keys averages the through-defense "
                     "logits over projection seeds; it requires a gradient "
                     "attack (fgsm/rand_fgsm/pgd/cw), --defense_type "
                     "defense_gan, and --attack_through_defense yes")
        if args.pgd_rec_penalty:
            ap.error("--attack_eot_keys wraps the logits target; the "
                     "--pgd_rec_penalty loss path does not support it")
        if args.eval_z0 == "both":
            ap.error("--eval_z0 both needs a single attack z0 to replay, "
                     "but --attack_eot_keys consumes K seeds per "
                     "evaluation")
    if args.pgd_rec_penalty and (args.attack_type != "pgd"
                                 or args.defense_type != "defense_gan"
                                 or args.attack_through_defense != "yes"):
        ap.error("--pgd_rec_penalty penalizes the through-defense "
                 "projection loss; it requires --attack_type pgd, "
                 "--defense_type defense_gan, and "
                 "--attack_through_defense yes")
    if args.pgd_rec_center is not None and not args.pgd_rec_penalty:
        ap.error("--pgd_rec_center shapes the --pgd_rec_penalty term; "
                 "set a nonzero --pgd_rec_penalty")
    if args.spsa_rec_penalty and (args.attack_type != "spsa"
                                  or args.defense_type != "defense_gan"
                                  or args.attack_through_defense != "yes"):
        ap.error("--spsa_rec_penalty penalizes the through-defense "
                 "projection loss; it requires --attack_type spsa, "
                 "--defense_type defense_gan, and "
                 "--attack_through_defense yes")
    if args.spsa_rec_center is not None and not args.spsa_rec_penalty:
        ap.error("--spsa_rec_center shapes the --spsa_rec_penalty term; "
                 "set a nonzero --spsa_rec_penalty")
    if args.spsa_center_quantiles is not None:
        if not args.spsa_rec_penalty:
            ap.error("--spsa_center_quantiles shapes the "
                     "--spsa_rec_penalty term; set a nonzero "
                     "--spsa_rec_penalty")
        if args.spsa_rec_center is not None:
            ap.error("--spsa_center_quantiles and --spsa_rec_center are "
                     "mutually exclusive")
        lo_q, hi_q = args.spsa_center_quantiles
        if not 0.0 <= lo_q < hi_q <= 1.0:
            ap.error("--spsa_center_quantiles needs 0 <= LO < HI <= 1")
    if args.spsa_objective == "confident":
        if args.attack_type != "spsa" or args.defense_type != "defense_gan" \
                or args.attack_through_defense != "yes":
            ap.error("--spsa_objective confident requires --attack_type "
                     "spsa, --defense_type defense_gan and "
                     "--attack_through_defense yes")
        if args.spsa_margin_kappa is None:
            ap.error("--spsa_objective confident needs --spsa_margin_kappa")
    elif args.spsa_margin_kappa is not None:
        ap.error("--spsa_margin_kappa only shapes --spsa_objective "
                 "confident")
    if args.save_adv_pngs and not args.save_adv:
        ap.error("--save_adv_pngs writes beside the --save_adv npz; set "
                 "--save_adv PATH.npz")
    if args.load_adv:
        if args.attack_type != "none":
            ap.error("--load_adv replays the npz's adversarial set; use "
                     "--attack_type none")
        if args.save_adv:
            ap.error("--load_adv with --save_adv would re-save the same "
                     "set; drop one")
    if args.detect and args.attack_type == "none" and not args.load_adv:
        ap.error("--detect compares clean vs adversarial reconstruction "
                 "errors; it needs an --attack_type (or --load_adv)")
    if args.detect_save and not args.detect:
        ap.error("--detect_save saves the --detect statistics; add "
                 "--detect")
    if args.detect_passes < 1:
        ap.error("--detect_passes must be >= 1")
    if args.detect_passes > 1 and not args.detect:
        ap.error("--detect_passes shapes the --detect scoring; add "
                 "--detect")
    if args.attack_grad == "bpda" and (args.defense_type != "defense_gan"
                                       or args.attack_type == "none"
                                       or args.attack_through_defense
                                       != "yes"):
        ap.error("--attack_grad bpda approximates the gradient through "
                 "the defense; it requires --defense_type defense_gan, an "
                 "attack, and --attack_through_defense yes")


def make_craft(args, cfg, gan, logits_fn, attack_target, through_defense,
               attack_rec_iters, x_test, k_att, device):
    """craft(xb, yb, key) -> x_adv for the chosen attack (tensors on the
    device, key an integer seed)."""
    if args.attack_type == "fgsm":
        def craft(xb, yb, k):
            tgt = ((lambda x: attack_target(x, k)) if through_defense
                   else attack_target)
            return fgsm(tgt, xb, yb, args.fgsm_eps)
        return craft
    if args.attack_type == "rand_fgsm":
        def craft(xb, yb, k):
            kz, kn = split_rand_fgsm_key(k)   # kz replayed by attack_z0_key
            tgt = ((lambda x: attack_target(x, kz)) if through_defense
                   else attack_target)
            return rand_fgsm(tgt, xb, yb, args.fgsm_eps, args.alpha,
                             generator_for(kn, xb.device))
        return craft
    if args.attack_type == "pgd":
        per_step = args.pgd_z0 == "per_step"
        pgd_loss = None
        if args.pgd_rec_penalty:
            pgd_loss = make_attack_loss(
                gan, logits_fn, cfg, rec_iters=attack_rec_iters,
                grad_mode=args.attack_grad,
                rec_penalty=args.pgd_rec_penalty,
                rec_center=args.pgd_rec_center)
        chunk = args.pgd_chunk_iters
        if chunk == 0:
            chunk = ((5 if args.attack_grad == "exact" else 20)
                     if through_defense else -1)
        if chunk > 0:
            chunk = max(1, min(chunk, args.pgd_iters))
            print(f"PGD: progress every {chunk} steps")
            chunked = make_chunked_pgd(
                attack_target, eps=args.fgsm_eps,
                eps_iter=args.pgd_eps_iter, nb_iter=args.pgd_iters,
                rand_init=args.pgd_rand_init, chunk_iters=chunk,
                keyed_logits=through_defense, per_step_keys=per_step,
                verbose=through_defense, loss_fn=pgd_loss)
            return lambda xb, yb, k: chunked(xb, yb, k)

        def craft(xb, yb, k):
            return pgd(attack_target, xb, yb, args.fgsm_eps,
                       args.pgd_eps_iter, args.pgd_iters, key=k,
                       rand_init=args.pgd_rand_init,
                       keyed_logits=through_defense,
                       per_step_keys=per_step, loss_fn=pgd_loss)
        return craft
    if args.attack_type == "spsa":
        return _make_spsa_craft(args, gan, logits_fn, through_defense,
                                attack_rec_iters, x_test, k_att, device)
    cw_cfg = CWConfig(binary_search_steps=args.cw_binary_search_steps,
                      max_iterations=args.cw_max_iterations)
    chunk = args.cw_chunk_iters
    if chunk == 0:
        chunk = 100 if (through_defense or args.cw_abort_early) else -1
    if chunk > 0:
        chunk = effective_cw_chunk(cw_cfg, chunk, args.cw_abort_early)
        print(f"CW: chunks of {chunk} iterations"
              + (", abort_early" if args.cw_abort_early else ""))
        chunked = make_chunked_cw(attack_target, cw_cfg, chunk_iters=chunk,
                                  abort_early=args.cw_abort_early,
                                  verbose=through_defense,
                                  keyed_logits=through_defense)
        return lambda xb, yb, k: chunked(
            xb, yb, k if through_defense else None)
    return lambda xb, yb, k: carlini_wagner_l2(
        attack_target, xb, yb, cw_cfg, key=k if through_defense else None)


def _make_spsa_craft(args, gan, logits_fn, through_defense,
                     attack_rec_iters, x_test, k_att, device):
    """SPSA's loss: through the defense it is the deployed inference path
    (gan.reconstruct, back_prop=False: the fused kernel on the card) plus
    the classifier; otherwise the bare classifier's margin."""
    cen_q = args.spsa_center_quantiles
    clean_err_sorted = None
    cen_holder = {"cen": None}          # [B] per attack batch
    if through_defense:
        lam = args.spsa_rec_penalty
        cen = args.spsa_rec_center
        kappa = args.spsa_margin_kappa
        confident = args.spsa_objective == "confident"
        if cen_q is not None:
            n_cal = int(min(256, x_test.shape[0]))
            with torch.no_grad():
                res_cal = gan.reconstruct(
                    x_test[:n_cal],
                    generator_for(fold_seed(k_att, 7709), device),
                    rec_iters=attack_rec_iters)
            clean_err_sorted = np.sort(res_cal.loss.cpu().numpy().astype(
                np.float64))
            print(f"spsa dispersed centers: per-image clean rec-err "
                  f"quantiles u ~ U[{cen_q[0]}, {cen_q[1]}] from {n_cal} "
                  f"clean reconstructions (median "
                  f"{float(np.median(clean_err_sorted)):.5f})")

        def pen(rl, cenv):
            if not lam:
                return torch.zeros_like(rl)
            if cen_q is not None:
                return lam * torch.abs(rl - cenv)
            return lam * (torch.abs(rl - cen) if cen is not None else rl)

        def spsa_loss(x_flat, y_flat, k):
            res = gan.reconstruct(x_flat, generator_for(k, device),
                                  rec_iters=attack_rec_iters)
            logits = logits_fn(res.x_hat)
            if not (lam or confident):
                return margin_loss(logits, y_flat)
            cb = cen_holder["cen"]
            cenv = (torch.zeros_like(res.loss) if cb is None
                    else cb.repeat(x_flat.shape[0] // cb.shape[0]))
            if confident:
                return confident_margin_loss(logits, y_flat) - kappa \
                    - pen(res.loss, cenv)
            return margin_loss(logits, y_flat) - pen(res.loss, cenv)
    else:
        def spsa_loss(x_flat, y_flat, k):
            return margin_loss(logits_fn(x_flat), y_flat)
    spsa_attack = make_spsa(
        spsa_loss, eps=args.fgsm_eps, nb_iter=args.spsa_iters,
        n_samples=args.spsa_samples, delta=args.spsa_delta,
        lr=args.spsa_lr, chunk_samples=args.spsa_chunk,
        verbose=through_defense)

    def craft(xb, yb, k):
        if clean_err_sorted is not None:
            gen = generator_for(fold_seed(k, 2 ** 24), "cpu")
            u = cen_q[0] + (cen_q[1] - cen_q[0]) * torch.rand(
                xb.shape[0], generator=gen, dtype=torch.float64).numpy()
            cen_holder["cen"] = torch.as_tensor(
                np.quantile(clean_err_sorted, u), dtype=torch.float32,
                device=xb.device)
        return spsa_attack(xb, yb, k)

    return craft


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    check_args(ap, args)
    if args.online_training:
        args.train_on_recs = True
    cfg = cfg_from_args(args)
    device = device_from_args(args)

    ds = load_data(cfg)
    x_train, y_train = ds.load("train")
    x_test, y_test = ds.load("test")
    x_test, y_test = limit(x_test, y_test, args.num_tests)

    adv_meta = None
    x_adv_loaded = None
    if args.load_adv:
        with np.load(args.load_adv, allow_pickle=False) as d:
            adv_meta = json.loads(str(d["meta"]))
            x_test, y_test = limit(d["x_clean"], d["y"], args.num_tests)
            x_adv_loaded = np.asarray(d["x_adv"])[:x_test.shape[0]]
        print(f"replaying adversarial set {args.load_adv} "
              f"({x_adv_loaded.shape[0]} examples; attack "
              f"{adv_meta.get('attack')}, meta {adv_meta})")

    need_gan = (args.defense_type == "defense_gan" or args.train_on_recs
                or args.detect)
    gan = load_gan(cfg, device, require_trained=need_gan)

    base = cfg.seed + 7
    k_clf, k_att, k_eval = (fold_seed(base, i) for i in range(3))
    timer = PhaseTimer(device)
    with timer.phase("train_classifier"):
        clf = get_classifier(cfg, args, gan, x_train, y_train, k_clf, device)
    logits_fn = clf.logits_fn()

    with timer.phase("clean_eval"):
        clean_acc = model_eval(logits_fn, x_test, y_test)
    print(f"clean accuracy ({args.model}): {clean_acc:.4f}")

    clean_defended_acc = None
    kernels = {}
    if args.defense_type == "defense_gan":
        with timer.phase("purify_classify_clean"):
            clean_defended_acc = model_eval_gan(
                gan, logits_fn, x_test, y_test,
                gen=generator_for(k_eval, device))
        kernels["purify_classify_clean"] = gan.last_kernel
        print(f"clean accuracy through Defense-GAN: {clean_defended_acc:.4f}"
              f" [{gan.last_kernel}]")

    attack_rec_iters = args.attack_rec_iters or cfg.rec_iters
    through_defense = (args.defense_type == "defense_gan"
                       and args.attack_type != "none"
                       and args.attack_through_defense == "yes")
    if through_defense and args.attack_type == "spsa":
        attack_target = None         # SPSA queries the inference path
    elif through_defense:
        attack_target = make_attack_target(gan, logits_fn, cfg,
                                           rec_iters=attack_rec_iters,
                                           grad_mode=args.attack_grad)
        if args.attack_eot_keys > 1:
            attack_target = eot_over_keys(attack_target,
                                          args.attack_eot_keys)
            print(f"attack target: EOT over {args.attack_eot_keys} "
                  "projection seeds per evaluation")
    else:
        attack_target = logits_fn

    t0 = time.time()
    n_batches = 0
    if args.load_adv:
        x_adv = x_adv_loaded
    elif args.attack_type == "none":
        x_adv = x_test.copy()
    else:
        craft = make_craft(args, cfg, gan, logits_fn, attack_target,
                           through_defense, attack_rec_iters, x_test, k_att,
                           device)
        advs = []
        bs = args.attack_batch
        n = x_test.shape[0]
        pad_to = ((n + bs - 1) // bs) * bs
        xp = np.concatenate([x_test, np.zeros((pad_to - n,)
                                              + x_test.shape[1:],
                                              x_test.dtype)])
        yp = np.concatenate([y_test, np.zeros(pad_to - n, y_test.dtype)])
        for i in range(0, pad_to, bs):
            xb = torch.as_tensor(xp[i:i + bs], device=device)
            yb = torch.as_tensor(yp[i:i + bs].astype(np.int64),
                                 device=device)
            advs.append(craft(xb, yb, attack_batch_key(k_att, i))
                        .detach().cpu().numpy())
            n_batches += 1
        if args.attack_type == "spsa" and through_defense:
            kernels["spsa_queries"] = gan.last_kernel
        x_adv = np.concatenate(advs)[:n]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    attack_time = time.time() - t0
    timer.record("attack", attack_time)
    print(f"crafted {args.attack_type} adversarial examples in "
          f"{attack_time:.1f}s ({n_batches} batches)")

    if args.save_adv:
        ensure_dir(os.path.dirname(args.save_adv) or ".")
        meta = {"dataset": cfg.type, "attack": args.attack_type,
                "attack_grad": (args.attack_grad if through_defense
                                else None),
                "attack_through_defense": args.attack_through_defense,
                "attack_eot_keys": args.attack_eot_keys,
                "package": "defensegan_torch"}
        if args.attack_type in ("fgsm", "rand_fgsm", "pgd", "spsa"):
            meta["fgsm_eps"] = args.fgsm_eps
        if args.attack_type == "spsa":
            meta.update(spsa_meta(args))
        if args.attack_type == "pgd":
            meta.update(pgd_iters=args.pgd_iters,
                        pgd_eps_iter=args.pgd_eps_iter,
                        pgd_z0=args.pgd_z0,
                        pgd_rec_penalty=args.pgd_rec_penalty,
                        pgd_rec_center=args.pgd_rec_center)
        if args.attack_type == "cw":
            meta.update(cw_max_iterations=args.cw_max_iterations,
                        cw_binary_search_steps=args.cw_binary_search_steps)
        np.savez(args.save_adv, x_adv=x_adv, y=y_test, x_clean=x_test,
                 meta=json.dumps(meta))
        print(f"saved adversarial set to {args.save_adv}")
        if args.save_adv_pngs:
            png_dir = os.path.splitext(args.save_adv)[0] + "_pngs"
            labels = np.asarray(y_test).tolist()
            save_images_files(x_test, png_dir, prefix="orig", labels=labels)
            save_images_files(x_adv, png_dir, prefix="adv", labels=labels)
            print(f"wrote {2 * len(x_adv)} per-image PNGs under {png_dir}/")

    with timer.phase("adv_eval"):
        adv_acc = model_eval(logits_fn, x_adv, y_test)
    print(f"adversarial accuracy, NO defense: {adv_acc:.4f}")

    if args.save_images and args.defense_type == "defense_gan":
        save_trio(args, cfg, gan, x_test, x_adv, y_test,
                  generator_for(fold_seed(k_eval, 99), device))

    defended_acc = None
    defended_acc_attack_z0 = None
    defended_correct_adv = None
    if args.defense_type == "defense_gan":
        t0 = time.time()
        with timer.phase("purify_classify_adv"):
            defended_acc, defended_correct_adv = model_eval_gan(
                gan, logits_fn, x_adv, y_test,
                gen=generator_for(k_eval, device), return_correct=True)
        kernels["purify_classify_adv"] = gan.last_kernel
        print(f"adversarial accuracy, Defense-GAN (R={cfg.rec_rr}, "
              f"L={cfg.rec_iters}): {defended_acc:.4f} "
              f"[{time.time() - t0:.1f}s, {gan.last_kernel}]")
        if args.eval_z0 == "both" and through_defense:
            # the attack graph's own z0 (same seeds, batches and L) on the
            # attack graph's path: the generic generator (kernel="xla")
            def z0_fn(lo):
                return sample_z0(generator_for(
                    attack_z0_key(k_att, lo, args.attack_type), device),
                    args.attack_batch, cfg.rec_rr, cfg.latent_dim)
            with timer.phase("purify_classify_adv_attack_z0"):
                defended_acc_attack_z0 = model_eval_gan(
                    gan, logits_fn, x_adv, y_test,
                    batch_size=args.attack_batch,
                    rec_iters=attack_rec_iters, rec_kernel="xla",
                    z0_fn=z0_fn)
            print(f"adversarial accuracy, Defense-GAN with the ATTACK's "
                  f"z0 (L={attack_rec_iters}): "
                  f"{defended_acc_attack_z0:.4f}")
    elif args.defense_type == "adv_tr":
        defended_acc = adv_acc

    det = {}
    if args.detect:
        det = run_detection(args, cfg, gan, logits_fn, x_test, x_adv,
                            y_test, k_eval, defended_correct_adv, adv_meta,
                            timer, device)
        kernels["detect"] = gan.last_kernel

    ensure_dir(args.results_dir)
    record = results_row(args, cfg, adv_meta, through_defense,
                         attack_rec_iters, x_test, clean_acc,
                         clean_defended_acc, adv_acc, defended_acc,
                         defended_acc_attack_z0, det, attack_time, timer)
    record.update(last_kernel=kernels, attack_batches=n_batches,
                  device=device_record(device), package="defensegan_torch")
    print(f"phase breakdown: {timer}")
    append_jsonl(os.path.join(args.results_dir, "whitebox.jsonl"), record)
    print(json.dumps(record))
    return record


def save_trio(args, cfg, gan, x_test, x_adv, y_test, gen) -> None:
    """--save_images: the first 16 originals, their adversarial images and
    the purified adversarial images, as one grid (rows: original |
    adversarial | purified) and as per-image PNGs."""
    n_show = min(16, x_test.shape[0])
    res = gan.reconstruct(x_adv[:n_show], gen)
    purified = res.x_hat.float().cpu().numpy()
    trio = np.stack([x_test[:n_show], x_adv[:n_show], purified], 1)
    stem = os.path.join(args.results_dir,
                        f"whitebox_{cfg.type}_{args.attack_type}")
    path = save_images(trio.reshape((-1,) + x_test.shape[1:]),
                       stem + ".png", grid=(n_show, 3))
    print(f"wrote {path} (rows: original | adversarial | purified)")
    labels = np.asarray(y_test[:n_show]).tolist()
    save_images_files(x_test[:n_show], stem + "_pngs", prefix="orig",
                      labels=labels)
    save_images_files(x_adv[:n_show], stem + "_pngs", prefix="adv",
                      labels=labels)
    save_images_files(purified, stem + "_pngs", prefix="purified",
                      labels=labels)
    print(f"wrote {3 * n_show} per-image PNGs under {stem}_pngs/")


def spsa_meta(args) -> dict:
    return dict(spsa_iters=args.spsa_iters, spsa_samples=args.spsa_samples,
                spsa_delta=args.spsa_delta, spsa_lr=args.spsa_lr,
                spsa_rec_penalty=args.spsa_rec_penalty,
                spsa_rec_center=args.spsa_rec_center,
                spsa_center_quantiles=args.spsa_center_quantiles,
                spsa_objective=args.spsa_objective,
                spsa_margin_kappa=args.spsa_margin_kappa)


def run_detection(args, cfg, gan, logits_fn, x_test, x_adv, y_test, k_eval,
                  defended_correct_adv, adv_meta, timer, device) -> dict:
    """Detection by reconstruction error (paper section 5.1): the clean and
    adversarial passes share their seeds (paired restart draws)."""
    with timer.phase("detect"):
        k_det = fold_seed(k_eval, 555)
        passes_c, passes_a = [], []
        for p in range(args.detect_passes):
            kp = k_det if p == 0 else fold_seed(k_det, p)
            passes_c.append(detection_features(
                gan, x_test, logits_fn, gen=generator_for(kp, device)))
            passes_a.append(detection_features(
                gan, x_adv, logits_fn, gen=generator_for(kp, device)))
        errs_clean_pp = np.stack([f.errs for f in passes_c])
        errs_adv_pp = np.stack([f.errs for f in passes_a])
        marg_clean_pp = np.stack([f.margins for f in passes_c])
        marg_adv_pp = np.stack([f.margins for f in passes_a])
        errs_clean = errs_clean_pp.mean(0)
        errs_adv = errs_adv_pp.mean(0)
        marg_clean = marg_clean_pp.mean(0)
        marg_adv = marg_adv_pp.mean(0)
    d = {"auc": roc_auc(errs_clean, errs_adv)}
    d["tpr"], _ = tpr_at_fpr(errs_clean, errs_adv, 0.05)
    d["rec_err_clean"] = float(errs_clean.mean())
    d["rec_err_adv"] = float(errs_adv.mean())
    s_clean_2s = two_sided_scores(errs_clean, errs_clean)
    s_adv_2s = two_sided_scores(errs_adv, errs_clean)
    d["auc_2s"] = roc_auc(s_clean_2s, s_adv_2s)
    d["tpr_2s"], _ = tpr_at_fpr(s_clean_2s, s_adv_2s, 0.05)
    d["margin_clean"] = float(marg_clean.mean())
    d["margin_adv"] = float(marg_adv.mean())
    s_clean_comb = combined_scores(errs_clean, marg_clean, errs_clean,
                                   marg_clean)
    s_adv_comb = combined_scores(errs_adv, marg_adv, errs_clean, marg_clean)
    d["auc_comb"] = roc_auc(s_clean_comb, s_adv_comb)
    d["tpr_comb"], _ = tpr_at_fpr(s_clean_comb, s_adv_comb, 0.05)
    print(f"attack detection by rec error: AUC {d['auc']:.4f}, detection "
          f"rate {d['tpr']:.4f} @ 5% FPR (mean rec err clean "
          f"{d['rec_err_clean']:.5f} vs adversarial {d['rec_err_adv']:.5f};"
          f" medians {float(np.median(errs_clean)):.5f} vs "
          f"{float(np.median(errs_adv)):.5f}); two-sided AUC "
          f"{d['auc_2s']:.4f}, rate {d['tpr_2s']:.4f}")
    print(f"two-feature detection (rec err + purified margin): AUC "
          f"{d['auc_comb']:.4f}, rate {d['tpr_comb']:.4f} @ 5% FPR (mean "
          f"purified margin clean {d['margin_clean']:.3f} vs adversarial "
          f"{d['margin_adv']:.3f}; clean margin median "
          f"{float(np.median(marg_clean)):.3f})")
    if defended_correct_adv is not None:
        d["us"], _ = undetected_success_rate(errs_clean, errs_adv,
                                             ~defended_correct_adv)
        d["us_2s"], _ = undetected_success_rate(s_clean_2s, s_adv_2s,
                                                ~defended_correct_adv)
        d["us_comb"], _ = undetected_success_rate(s_clean_comb, s_adv_comb,
                                                  ~defended_correct_adv)
        print(f"undetected successful attacks @ 5% FPR: {d['us']:.4f} "
              f"one-sided / {d['us_2s']:.4f} two-sided / "
              f"{d['us_comb']:.4f} two-feature")
    if args.detect_save:
        ensure_dir(os.path.dirname(args.detect_save) or ".")
        meta = {"dataset": cfg.type, "model": args.model,
                "attack": args.attack_type, "defense": args.defense_type,
                "fgsm_eps": args.fgsm_eps,
                "detect_passes": args.detect_passes,
                "rec_rr": cfg.rec_rr, "rec_iters": cfg.rec_iters,
                "rec_init": cfg.rec_init, "package": "defensegan_torch"}
        if adv_meta is not None:
            meta["attack"] = adv_meta.get("attack")
            meta["replayed_from"] = args.load_adv
            meta["adv_meta"] = adv_meta
        if args.attack_eot_keys > 1:
            meta["attack_eot_keys"] = args.attack_eot_keys
        if args.attack_type == "pgd":
            meta.update(pgd_rec_penalty=args.pgd_rec_penalty,
                        pgd_rec_center=args.pgd_rec_center,
                        pgd_iters=args.pgd_iters)
        if args.attack_type == "spsa":
            meta.update(spsa_meta(args))
        arrays = {"errs_clean": errs_clean, "errs_adv": errs_adv,
                  "margins_clean": marg_clean, "margins_adv": marg_adv,
                  "all_losses_clean": passes_c[0].all_losses,
                  "all_losses_adv": passes_a[0].all_losses,
                  "y": np.asarray(y_test, np.int32)}
        if args.detect_passes > 1:
            arrays.update(errs_clean_pp=errs_clean_pp,
                          errs_adv_pp=errs_adv_pp,
                          margins_clean_pp=marg_clean_pp,
                          margins_adv_pp=marg_adv_pp,
                          preds_clean_pp=np.stack(
                              [f.preds for f in passes_c]),
                          preds_adv_pp=np.stack([f.preds for f in passes_a]))
        if defended_correct_adv is not None:
            arrays["defended_correct_adv"] = np.asarray(
                defended_correct_adv, bool)
        np.savez(args.detect_save, meta=json.dumps(meta), **arrays)
        print(f"saved per-example detection statistics to "
              f"{args.detect_save}")
    return d


def results_row(args, cfg, adv_meta, through_defense, attack_rec_iters,
                x_test, clean_acc, clean_defended_acc, adv_acc,
                defended_acc, defended_acc_attack_z0, det, attack_time,
                timer) -> dict:
    """The JAX CLI's results row, key for key."""
    at = args.attack_type

    def only(kind, value):
        return value if at == kind else None

    return {
        "script": "whitebox", "dataset": cfg.type, "model": args.model,
        "attack": (f"{adv_meta.get('attack', '?')}_replay"
                   if args.load_adv else at),
        "load_adv": args.load_adv, "adv_meta": adv_meta,
        "detect_passes": args.detect_passes if args.detect else None,
        "defense": args.defense_type,
        "fgsm_eps": args.fgsm_eps, "num_tests": int(x_test.shape[0]),
        "rec_rr": cfg.rec_rr, "rec_iters": cfg.rec_iters,
        "rec_init": (cfg.rec_init if cfg.rec_init != "random" else None),
        "attack_rec_iters": attack_rec_iters if at != "none" else None,
        "attack_eot_keys": (args.attack_eot_keys
                            if args.attack_eot_keys > 1 else None),
        "attack_batch": args.attack_batch,
        "cw_max_iterations": only("cw", args.cw_max_iterations),
        "cw_binary_search_steps": only("cw", args.cw_binary_search_steps),
        "cw_abort_early": only("cw", args.cw_abort_early),
        "pgd_iters": only("pgd", args.pgd_iters),
        "pgd_eps_iter": only("pgd", args.pgd_eps_iter),
        "pgd_rand_init": only("pgd", args.pgd_rand_init),
        "pgd_z0": (args.pgd_z0 if at == "pgd" and through_defense
                   else None),
        "pgd_rec_penalty": only("pgd", args.pgd_rec_penalty),
        "pgd_rec_center": only("pgd", args.pgd_rec_center),
        "spsa_iters": only("spsa", args.spsa_iters),
        "spsa_samples": only("spsa", args.spsa_samples),
        "spsa_delta": only("spsa", args.spsa_delta),
        "spsa_lr": only("spsa", args.spsa_lr),
        "spsa_rec_penalty": only("spsa", args.spsa_rec_penalty),
        "spsa_rec_center": only("spsa", args.spsa_rec_center),
        "spsa_center_quantiles": only("spsa", args.spsa_center_quantiles),
        "spsa_objective": only("spsa", args.spsa_objective),
        "spsa_margin_kappa": only("spsa", args.spsa_margin_kappa),
        "attack_through_defense": args.attack_through_defense,
        "attack_grad": ("none" if at == "spsa" else args.attack_grad)
        if through_defense else None,
        "attack_z0": (("per_step" if at == "spsa"
                       or (at == "pgd" and args.pgd_z0 == "per_step")
                       else "per_batch") if through_defense else None),
        "eval_z0": args.eval_z0,
        "train_on_recs": args.train_on_recs,
        "clean_acc": clean_acc, "clean_defended_acc": clean_defended_acc,
        "adv_acc_no_defense": adv_acc,
        "defended_acc": defended_acc,
        "defended_acc_attack_z0": defended_acc_attack_z0,
        "detection_auc": det.get("auc"),
        "detection_tpr_at_fpr05": det.get("tpr"),
        "detection_auc_two_sided": det.get("auc_2s"),
        "detection_tpr_at_fpr05_two_sided": det.get("tpr_2s"),
        "detection_auc_combined": det.get("auc_comb"),
        "detection_tpr_at_fpr05_combined": det.get("tpr_comb"),
        "undetected_success_rate": det.get("us"),
        "undetected_success_rate_two_sided": det.get("us_2s"),
        "undetected_success_rate_combined": det.get("us_comb"),
        "margin_clean_mean": det.get("margin_clean"),
        "margin_adv_mean": det.get("margin_adv"),
        "rec_err_clean_mean": det.get("rec_err_clean"),
        "rec_err_adv_mean": det.get("rec_err_adv"),
        "attack_time_s": round(attack_time, 2),
        "phases": timer.summary(),
    }


if __name__ == "__main__":
    main()
