"""The readings that the check's limits are set from, at a cell's own
size, many seeds in one process (the benchmark's own runs never run
this):

    python3 benchmark/control.py --workload mnist_fast.bulk10k \
        --seeds 11,12,13 --modes program,int8,fp8,frozen --seconds 1

  program  the program as the configuration states it (sound runs: the
           lower readings)
  int8     the program with its own int8 projection path switched on
           (PROJECTION_KERNEL pallas_int8: v2i on the wide generator; the
           deep generator has no int8 loop and runs its bf16 one)
  fp8      the plain reference in the program's place, every product's
           operands rounded to fp8 e4m3 (reference/numerics.py): the
           control one precision step below the configuration's bfloat16,
           for the projection, G(z*) and the classifier alike (and under
           encoder init for E(x), which starts restart 0)
  frozen   a fault: the float32 reference in the program's place with
           the upper half of every image's restarts left at their draws
           (their losses reported where they started; under encoder init
           restart 0 starts at the float32 E(x))

Each (seed, mode) prints one JSON line of the compared numbers and the
diagnostics beside them, and appends it to --out (benchmark/out/). A
window here is as short as --seconds lets it be, but never samples fewer
requests than a run of the cell does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from functools import partial
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import check, harness, spec  # noqa: E402
from benchmark.system import ProgramSystem  # noqa: E402
from benchmark.reference import classifier as ref_classifier  # noqa: E402
from benchmark.reference import detector as ref_detector  # noqa: E402
from benchmark.reference.generator import generate  # noqa: E402
from benchmark.reference.numerics import (FP8, FP32,  # noqa: E402
                                          Precision, float32_products)
from benchmark.reference.projection import (Projection,  # noqa: E402
                                             project)


class _Chunk(NamedTuple):
    x_hat: torch.Tensor
    z_star: torch.Tensor
    loss: torch.Tensor
    all_losses: torch.Tensor


class _Result(NamedTuple):
    pred: np.ndarray
    flagged: np.ndarray
    rec_err: np.ndarray
    margin: np.ndarray


class ReferenceSystem:
    """The plain reference put in the program's place: DefendedPipeline's
    calibrate / predict semantics (two-sided detector) on the reference's
    projection and classifier at precision `prec`, in chunks of `block`
    images, reporting its chunks to the recorder as the program's
    pass-through does (no program path: path_mismatch reads 0). frozen:
    restarts from this index on are left at their draws (a fault). Under
    encoder init restart 0 starts at the reference's E(x) at `prec`
    (enc_w: the encoder's weights)."""

    def __init__(self, conf: Dict, gen_w, clf_w, device, recorder,
                 prec: Precision, block: int = 1024,
                 frozen: Optional[int] = None, enc_w=None):
        self.conf, self.recorder, self.prec = conf, recorder, prec
        self.device, self.block, self.frozen = device, block, frozen
        self.gen = partial(generate, gen_w, check.shape_of(conf), prec=prec)
        self.clf_w = clf_w
        self.enc, self.enc_w = check.encoder_of(conf), enc_w
        self.center = self.threshold = None

    def _run(self, x: np.ndarray, z0_fn):
        pr = self.conf["projection"]
        preds, errs, margins = [], [], []
        with float32_products():
            for lo in range(0, x.shape[0], self.block):
                xb = torch.as_tensor(x[lo:lo + self.block],
                                     device=self.device)
                b = xb.shape[0]
                z0 = z0_fn(0, lo)[:b]
                if self.enc is not None:
                    z0 = check.encoder_starts(self.enc_w, self.enc, xb, z0,
                                              prec=self.prec)
                p = self._project(xb, z0, pr)
                rows = torch.arange(b, device=self.device)
                res = _Chunk(p.x_hat, p.z_final[rows, p.best],
                             p.losses[rows, p.best], p.losses)
                self.recorder.rows += b
                if self.recorder.keep:
                    self.recorder.chunks.append((lo, b, res))
                with torch.no_grad():
                    logits = ref_classifier.logits(self.clf_w, p.x_hat,
                                                   self.prec)
                top2 = torch.topk(logits, 2, dim=1).values
                preds.append(torch.argmax(logits, 1).cpu().numpy())
                margins.append((top2[:, 0] - top2[:, 1]).double().cpu()
                               .numpy())
                errs.append(res.loss.double().cpu().numpy())
        return (np.concatenate(preds), np.concatenate(errs),
                np.concatenate(margins))

    def _project(self, xb, z0, pr):
        kw = dict(lr=pr["lr"], momentum=pr["momentum"])
        if self.frozen is None:
            return project(self.gen, xb, z0, iters=pr["iters"], **kw)
        f = self.frozen
        moved = project(self.gen, xb, z0[:, :f], iters=pr["iters"], **kw)
        still = project(self.gen, xb, z0[:, f:], iters=0, **kw)
        z = torch.cat([moved.z_final, still.z_final], 1)
        losses = torch.cat([moved.losses, still.losses], 1)
        best = torch.argmin(losses, dim=1)
        with torch.no_grad():
            z_star = z[torch.arange(z.shape[0], device=z.device), best]
            x_hat = (self.gen(z_star) + 1.0) * 0.5
        return Projection(z_final=z, losses=losses, best=best, x_hat=x_hat)

    def calibrate(self, x, z0_fn) -> None:
        _, errs, _ = self._run(x, z0_fn)
        self.center, self.threshold = ref_detector.calibrate(
            errs, self.conf["pipeline"]["fpr"])

    def predict(self, x, z0_fn):
        pred, errs, margin = self._run(x, z0_fn)
        flagged = ref_detector.scores(errs, self.center) > self.threshold
        return _Result(pred.astype(np.int32), flagged, errs, margin)


def readings(bench: Dict, cell: Dict, seed: int, mode: str,
             seconds: float, device: torch.device) -> Dict:
    conf = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    # as many requests as a run samples, whatever --seconds says
    traffic = dict(traffic, trace_requests=0)
    inputs = harness.Inputs(conf, traffic, seed, device)

    def make_system(recorder):
        if mode in ("fp8", "frozen"):
            return ReferenceSystem(
                conf, inputs.gen_w, inputs.clf_w, device, recorder,
                FP8 if mode == "fp8" else FP32,
                frozen=(conf["projection"]["restarts"] // 2
                        if mode == "frozen" else None), enc_w=inputs.enc_w)
        sys_conf = conf
        if mode == "int8":
            sys_conf = dict(conf, program_overrides=dict(
                conf["program_overrides"], PROJECTION_KERNEL="pallas_int8"))
        return ProgramSystem(sys_conf, inputs.gen_w, inputs.clf_w, device,
                             recorder, inputs.enc_w)

    t0 = time.perf_counter()
    keep = max(1, -(-conf["check"]["sample_images"]
                    // traffic["images_per_request"]))
    record, kept, recorder = harness.measure(
        inputs, make_system, seconds, False, t0, min_requests=keep,
        warm_up=False)
    correct, checked, diag = harness.judge_kept(inputs, kept, recorder.paths)
    return {"workload": cell["name"], "seed": seed, "mode": mode,
            "paths": dict(recorder.paths), "requests": len(record.requests),
            "seconds": time.perf_counter() - t0, "correct": correct,
            "numbers": {k: v["value"] for k, v in checked.items()},
            "diagnostics": diag}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=os.path.join(spec.BENCH_DIR, "out",
                                                  "readings.jsonl"),
                    help="also append each line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA device", file=sys.stderr)
        return 3
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    device = torch.device("cuda", 0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            line = json.dumps(readings(bench, cell, seed, mode,
                                       args.seconds, device))
            print(line, flush=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
