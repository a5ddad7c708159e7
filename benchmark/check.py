"""Whether what the timed path produced is correct: the program's answers
for a sample of the window's images, judged by the plain reference.

The sample (drawn from the seed, `sample_images` of the configuration)
comes from the requests the recorder kept. For each sampled image the
reference projects the same image from the same restart draws in float32
(TF32 off), and evaluates the generator and the classifier at what the
program returned; it recomputes the detector's calibration from the
calibration images and their draws. Numbers compared, each against its
limit in the configuration (`check.limits`):

  path_mismatch     projection calls of the whole run (set-up and window)
                    that ran another path than the configuration's `path`
                    (the resolved PROJECTION_KERNEL: 'pallas' is the bf16
                    kernel; a lower precision such as 'pallas_int8' or a
                    plain path is another): an exact comparison, limit 0
  restart_gap_p25   the 25th percentile over (image, restart) of
                    |loss_prog - loss_ref| / loss_ref: every restart's
                    final loss, as the program reports it, against the
                    reference's from the same draws (the L-step loop and
                    the loss the restart selection reads)
  restart_far_pct   the share (%) of (image, restart) pairs whose
                    |loss_prog - loss_ref| exceeds `far_share` of the
                    reference's descent from the draw, loss_ref(z0) -
                    loss_ref: the 25th percentile cannot see a fault
                    confined to some of the restarts (a restart left where
                    it started reads 1)
  best_excess_max   the largest over images of (L(z*_prog) - min loss_ref)
                    / min loss_ref, L the exact (float32) loss: how far the
                    restart the program chose lies above the reference's
                    best; a row the loop skipped or left undone reads tens
                    of times its limit
  loss_fwd_gap_max  the largest |rec_err_prog - L(z*_prog)| / L(z*_prog):
                    the final loss the program reports for its own z*
  xhat_gap_max      the largest |x_hat_prog - (G_ref(z*_prog) + 1) / 2|
                    over pixels: G(z*), the purified image
  margin_gap_max    the largest |margin_prog - margin_ref(x_hat_prog)| /
                    max(1, |logits_ref|_max): the classifier
  pred_mismatch     images whose class differs from the reference's argmax
                    on x_hat_prog where the reference's top-2 margin is
                    wider than twice the margin limit (an exact
                    comparison: limit 0)
  flag_mismatch     images whose flag differs from |rec_err_prog -
                    center_ref| > threshold_ref, where that distance lies
                    farther than `flag_band` x (center_ref + threshold_ref)
                    from the threshold (limit 0)

x_hat, the margin, the class and L(z*_prog) are taken at the program's
own z* and x_hat: the reference follows the program from its state
there, and the loop that produced that state is judged by the first two
numbers. PERF.md gives the readings each limit was set from.

A configuration whose `projection.init` is "encoder" starts restart 0 at
the program's own encoder E(x) (harness.Inputs hands the program NaN in
that slot of the draws). The reference then projects from the draws with
restart 0 replaced by its float32 E(x) (reference/encoder.py), for the
calibration images and the sampled ones alike, and the loss at the start
(hence the descent) and z_rel read those starts; the diagnostics add
restart 0's own descent. With `init` absent or "random" the starts are
the draws themselves.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from benchmark.reference import classifier as ref_classifier
from benchmark.reference import detector as ref_detector
from benchmark.reference.encoder import EncoderShape, encode
from benchmark.reference.generator import GeneratorShape, generate
from benchmark.reference.numerics import FP32, Precision, float32_products
from benchmark.reference.projection import project, row_losses

NUMBERS = ("path_mismatch", "restart_gap_p25", "restart_far_pct",
           "best_excess_max", "loss_fwd_gap_max", "xhat_gap_max",
           "margin_gap_max", "pred_mismatch", "flag_mismatch")


class Sample(NamedTuple):
    """The program's answers for the sampled images, and their inputs."""
    x: torch.Tensor           # [M, H, W, C] in [0, 1]
    z0: torch.Tensor          # [M, R, k] the draws the program was handed
    all_losses: torch.Tensor  # [M, R] the program's final losses
    z_star: torch.Tensor      # [M, k]
    x_hat: torch.Tensor       # [M, H, W, C]
    pred: np.ndarray          # [M]
    flagged: np.ndarray       # [M] bool
    rec_err: np.ndarray       # [M]
    margin: np.ndarray        # [M]


def shape_of(conf: Dict) -> GeneratorShape:
    g = conf["generator"]
    return GeneratorShape(g["latent_dim"], g["base_hw"], tuple(g["channels"]),
                          g["out_channels"], g["kernel"], g["stride"])


def encoder_of(conf: Dict) -> Optional[EncoderShape]:
    """The encoder of an encoder-initialised projection (`projection.init`
    "encoder", the `encoder` block), or None for random starts."""
    init = conf["projection"].get("init", "random")
    if init == "random":
        return None
    if init != "encoder":
        raise ValueError(f"projection.init {init!r} is neither 'random' "
                         "nor 'encoder'")
    e = conf["encoder"]
    hw, _, c = conf["image_shape"]
    return EncoderShape(tuple(e["channels"]), e["z_dim"], c, hw, e["kernel"],
                        e["stride"], e["negative_slope"])


def encoder_starts(enc_w, enc: EncoderShape, x: torch.Tensor,
                   z0: torch.Tensor, block: int = 512,
                   prec: Precision = FP32) -> torch.Tensor:
    """The draws z0 [M, R, k] with restart 0 at E(x), x [M, H, W, C] in
    [0, 1]."""
    z = z0.float().clone()
    with torch.no_grad():
        for i in range(0, x.shape[0], block):
            z[i:i + block, 0] = encode(enc_w, enc, 2.0 * x[i:i + block]
                                       .float() - 1.0, prec)
    return z


def _project_blocks(gen, x, z0, pr, block):
    outs = [project(gen, x[i:i + block], z0[i:i + block], iters=pr["iters"],
                    lr=pr["lr"], momentum=pr["momentum"])
            for i in range(0, x.shape[0], block)]
    return (torch.cat([o.z_final for o in outs]),
            torch.cat([o.losses for o in outs]))


def reference_numbers(conf: Dict, gen_w, clf_w, x_calib, z0_calib,
                      s: Sample, block: int = 512, enc_w=None
                      ) -> Dict[str, float]:
    """Every compared number but path_mismatch (the run counts that), and
    the readings behind them (diagnostics). enc_w: the encoder's weights
    under encoder init."""
    shape = shape_of(conf)
    pr = conf["projection"]
    gen = partial(generate, gen_w, shape, prec=FP32)
    enc = encoder_of(conf)
    with float32_products():
        z0 = s.z0
        if enc is not None:
            z0_calib = encoder_starts(enc_w, enc, x_calib, z0_calib, block)
            z0 = encoder_starts(enc_w, enc, s.x, z0, block)
        _, calib_losses = _project_blocks(gen, x_calib, z0_calib, pr, block)
        center, threshold = ref_detector.calibrate(
            calib_losses.min(1).values.double().cpu().numpy(),
            conf["pipeline"]["fpr"])
        z_ref, l_ref = _project_blocks(gen, s.x, z0, pr, block)
        with torch.no_grad():
            m, r, k = z0.shape
            x_rows = (2.0 * s.x.float() - 1.0).reshape(m, 1, -1).expand(
                m, r, -1).reshape(m * r, -1)
            l_z0 = torch.cat([
                row_losses(gen(z0.reshape(m * r, k)[i:i + block].float()),
                           x_rows[i:i + block])
                for i in range(0, m * r, block)]).reshape(m, r)
            g_at = (gen(s.z_star.float()) + 1.0) * 0.5
            logits = ref_classifier.logits(clf_w, s.x_hat.float())
    rows = torch.arange(m, device=z0.device)
    c = torch.argmin(s.all_losses.float(), dim=1).to(z0.device)
    l_ref = l_ref.double()
    gaps = ((s.all_losses.double() - l_ref).abs() / l_ref).cpu().numpy()
    descent = (l_z0.double() - l_ref).clamp_min(1e-12)
    undone = ((s.all_losses.double() - l_ref).abs() / descent).cpu().numpy()
    l_min = l_ref.min(1).values.cpu().numpy()
    x_t = (2.0 * s.x.float() - 1.0).reshape(m, -1)
    l_at = ((2.0 * g_at - 1.0).reshape(m, -1) - x_t).pow(2).mean(1)
    l_at = l_at.double().cpu().numpy()
    top2 = torch.topk(logits, 2, dim=1).values
    margin_ref = (top2[:, 0] - top2[:, 1]).double().cpu().numpy()
    scale = np.maximum(1.0, logits.abs().amax(1).double().cpu().numpy())
    pred_ref = torch.argmax(logits, dim=1).cpu().numpy()
    ch = conf["check"]
    score = ref_detector.scores(s.rec_err, center)
    off = np.abs(score - threshold) / (center + threshold)
    flag_ref = score > threshold
    out = {
        "restart_gap_p25": float(np.quantile(gaps, 0.25)),
        "restart_far_pct": float(100.0 * np.mean(undone > ch["far_share"])),
        "best_excess_max": float(np.max((l_at - l_min) / l_min)),
        "loss_fwd_gap_max": float(np.max(np.abs(s.rec_err - l_at) / l_at)),
        "xhat_gap_max": float((s.x_hat.float() - g_at).abs().max()),
        "margin_gap_max": float(np.max(np.abs(s.margin - margin_ref)
                                       / scale)),
        "pred_mismatch": int(np.sum(
            (s.pred != pred_ref)
            & (margin_ref > 2 * ch["limits"]["margin_gap_max"] * scale))),
        "flag_mismatch": int(np.sum((s.flagged != flag_ref)
                                    & (off > ch["flag_band"]))),
    }
    z_c, z0_c = z_ref[rows, c], z0[rows, c].float()
    z_rel = ((s.z_star.float() - z_c).norm(dim=1)
             / (z_c - z0_c).norm(dim=1)).cpu().numpy()
    diag = {"images": int(m), "center_ref": center,
            "threshold_ref": threshold, "flagged": int(np.sum(s.flagged)),
            "flag_disagree_by_band": [int(np.sum((s.flagged != flag_ref)
                                                 & (off > b)))
                                      for b in (0.0, 0.0025, 0.005, 0.01)],
            "restart_gap_p10": float(np.quantile(gaps, 0.1)),
            "restart_gap_p50": float(np.quantile(gaps, 0.5)),
            "restart_undone_p50": float(np.quantile(undone, 0.5)),
            "restart_undone_p99": float(np.quantile(undone, 0.99)),
            "restart_undone_max": float(np.max(undone)),
            "descent_min": float(descent.min()),
            "loss_fwd_gap_p50": float(np.median(np.abs(s.rec_err - l_at)
                                                / l_at)),
            "z_rel_p50": float(np.median(z_rel)),
            "choice_differs": int(np.sum(
                c.cpu().numpy() != l_ref.argmin(1).cpu().numpy()))}
    if enc is not None:
        d0 = descent[:, 0].cpu().numpy()
        diag.update(enc_descent_min=float(d0.min()),
                    enc_descent_p50=float(np.median(d0)))
    return out, diag


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {value, limit}}) in NUMBERS order."""
    checked = {n: {"value": numbers[n], "limit": limits[n]} for n in NUMBERS}
    correct = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
                  for v in checked.values())
    return correct, checked

