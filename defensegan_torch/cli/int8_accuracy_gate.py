"""The accuracy-level int8 gate on the trained flagship (port of the JAX
package's scripts/int8_accuracy_gate.py).

    python scripts/int8_accuracy_gate_torch.py [--cfg PATH] [--device cuda]

With the trained mnist_fast GAN and classifier A (5 epochs, seed 5, on
the mnist train split): the bare classifier's clean and FGSM(0.1)
accuracy on the first 256 test images, then purified-clean and
FGSM(0.1)-defended accuracy (a defense-unaware attacker) through each
projection kernel, xla / pallas (v2, bf16) / pallas_int8 (v2i), the
reconstructor cache cleared before each, the restarts of every kernel
drawn from seed 9. The complement of scripts/int8_validate_torch.py's
loss-level checks: int8 must keep the defended accuracy of the other two.
The gate runs in exact_numerics(): cuDNN's deterministic algorithms and no
TF32 in products or convolutions, so a rerun on the same card and build
gives the same rows and the plain path is full float32.

Rows (the JAX script's printed keys plus `device`) go to
RESULTS_DIR/int8_accuracy_gate.jsonl (output/results_torch/, relative to
the working directory). On the CPU every kernel request runs the plain
path, so the three rows are one path there.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Callable, Optional

import torch

from defensegan_torch.attacks.fgsm import fgsm
from defensegan_torch.cli.common import (device_from_args, device_record,
                                         load_gan)
from defensegan_torch.configs import load_config
from defensegan_torch.data import get_dataset
from defensegan_torch.eval.accuracy import model_eval, model_eval_gan
from defensegan_torch.eval.classifier import train_classifier
from defensegan_torch.models import build_classifier
from defensegan_torch.utils.misc import append_jsonl, generator_for

FLAGSHIP_CFG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "gans", "mnist_fast.yml")
RESULTS_DIR = os.path.join("output", "results_torch")
KERNELS = ("xla", "pallas", "pallas_int8")
NUM_TESTS = 256
CLF_SEED, CLF_EPOCHS, REC_SEED, FGSM_EPS = 5, 5, 9, 0.1


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cfg", default=FLAGSHIP_CFG,
                    help="YAML config or a trained run's output dir "
                    "(default the flagship, mnist_fast.yml)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: the card; pass cpu "
                    "to run on the CPU)")
    return ap


@contextlib.contextmanager
def exact_numerics():
    """cuDNN's deterministic algorithms and no TF32 in cuBLAS products or
    cuDNN convolutions, the four switches restored on the way out."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    flags = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
             matmul.allow_tf32)
    cudnn.deterministic, cudnn.benchmark = True, False
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
         matmul.allow_tf32) = flags


def kernel_rows(gan, logits_fn, x, y, adv,
                z0_fn: Optional[Callable[[int], torch.Tensor]] = None
                ) -> list:
    """One row per kernel of KERNELS: clean_defended and fgsm01_defended,
    each kernel's cache cleared first and its restarts drawn from REC_SEED
    (the clean and the adversarial pass alike); z0_fn(lo) replays given
    draws instead (model_eval_gan)."""
    rows = []
    for kernel in KERNELS:
        gan.weights_changed()              # the reconstructor cache
        accs = [model_eval_gan(gan, logits_fn, xs, y,
                               gen=generator_for(REC_SEED, gan.device),
                               rec_kernel=kernel, z0_fn=z0_fn)
                for xs in (x, adv)]
        rows.append({"kernel": kernel, "clean_defended": accs[0],
                     "fgsm01_defended": accs[1], "path": gan.last_kernel})
    return rows


def main(argv=None, z0_fn: Optional[Callable[[int], torch.Tensor]] = None
         ) -> list:
    """Run the gate; returns the rows as written (z0_fn: model_eval_gan's
    draw replay, for the tests)."""
    args = build_parser().parse_args(argv)
    cfg = load_config(args.cfg)
    device = device_from_args(args)
    gan = load_gan(cfg, device, require_trained=True)
    dev_rec = device_record(device)
    out_path = os.path.join(RESULTS_DIR, "int8_accuracy_gate.jsonl")

    ds = get_dataset("mnist")
    x_tr, y_tr = ds.load("train")
    x_te, y_te = ds.load("test")
    x_te, y_te = x_te[:NUM_TESTS], y_te[:NUM_TESTS]

    # a rerun on the same card and build trains the same classifier and
    # crafts the same images
    with exact_numerics():
        model = build_classifier("A", num_classes=cfg.num_classes,
                                 image_shape=cfg.image_shape,
                                 gen=torch.Generator().manual_seed(CLF_SEED)
                                 ).to(device)
        clf = train_classifier(model, x_tr, y_tr, seed=CLF_SEED,
                               epochs=CLF_EPOCHS)
        logits_fn = clf.logits_fn()
        clean = model_eval(logits_fn, x_te, y_te)
        adv = fgsm(logits_fn, torch.as_tensor(x_te, device=device),
                   torch.as_tensor(y_te, device=device), FGSM_EPS)
        adv = adv.cpu().numpy()
        rows = [{"clean_acc": clean,
                 "fgsm01_acc": model_eval(logits_fn, adv, y_te)}]
        for row in kernel_rows(gan, logits_fn, x_te, y_te, adv,
                               z0_fn=z0_fn):
            print(f"{row['kernel']}: ran {row.pop('path')}", flush=True)
            rows.append(row)
    for row in rows:
        row["device"] = dev_rec
        append_jsonl(out_path, row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
