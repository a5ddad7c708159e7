"""The A/B of the deep loop's layout experiments against v3.

Port of the JAX package's A/B harnesses for its three v3 experiments
(scripts/pallas_v3p_bench.py, pallas_v3_packed_exp.py::main,
pallas_v3_ilp_exp.py::main) as one: `ab_variant` runs a variant and the
port's v3 on the same model, batch and z0, gates the variant's restart
selection against v3's, and times both in turns.

The gate, as the JAX harnesses state it: argmin agreement and the loss
deltas of the [B, R] final losses, held by the repository's selection
gate (eval/quality.py: tie-aware material disagreement <= 0.03, best-loss
p95 |delta| <= 2e-3, as chip_smoke.py holds each kernel against its plain
version) and, since seeded weights can leave that gate vacuous, by the
losses' relative error restart by restart (median <= 1e-2, p95 <= 1e-1,
chip_smoke.py's bounds for v3). v3p and packed change a rounding each, so
they are held by the gate; ilp changes none, so its z_final must equal
v3's bit for bit.

The inputs are the model's own G(z) of seeded latents, half of them with
+-0.1 uniform noise (the JAX harnesses take uniform noise images; G(z)
gives the projection a target it can reach, as chip_smoke.py's gates do).
Times: the loop alone (z_final) and the whole reconstruct (recon/s),
median of `repeats` after a warm-up, v3 and the variant in turns.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import NamedTuple

import numpy as np
import torch

from defensegan_torch.defense.fastgen import make_packed_apply, \
    pack_generator
from defensegan_torch.defense.project import rec_losses, tile_restarts
from defensegan_torch.eval.quality import (best_loss_p95,
                                           tie_aware_disagreement)
from defensegan_torch.experiments.fused_projection_v3p import (
    COUNTER as V3P_COUNTER, fused_projection_s2d_padded,
    s2d_padded_loop_plain)
from defensegan_torch.experiments.v3_ilp import (
    COUNTER as ILP_COUNTER, fused_projection_ilp, ilp_loop_plain)
from defensegan_torch.experiments.v3_packed import (
    COUNTER as PACKED_COUNTER, packed_loop_plain, run_packed)
from defensegan_torch.kernels.fused_projection_v3 import (
    fused_projection_s2d, make_s2d_reconstructor, pack_s2d)
from defensegan_torch.models.generator import from_image_space

MATERIAL_MAX = 0.03
P95_MAX = 2e-3
LOSS_REL_P50_MAX = 1e-2
LOSS_REL_P95_MAX = 1e-1
DEFAULT_CFG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "gans", "mnist.yml")


class Variant(NamedTuple):
    loop: object          # the wrapper: fused_projection_s2d's signature
    plain: object         # its plain version
    counter: str          # its build.LAUNCHES key
    source: str           # the CUDA source, the entry in it
    replaces: str         # the TPU kernel, file:line
    bit_equal: bool       # held bit for bit against v3 (else by the gate)


SOURCE = "defensegan_torch/csrc/fused_projection_v3_variants.cu"
VARIANTS = {
    "v3p": Variant(fused_projection_s2d_padded, s2d_padded_loop_plain,
                   V3P_COUNTER, SOURCE + " (fp_v3p_run)",
                   "scripts/fused_projection_v3p_exp.py:60", False),
    "packed": Variant(run_packed, packed_loop_plain, PACKED_COUNTER,
                      SOURCE + " (fp_v3_packed_run)",
                      "scripts/pallas_v3_packed_exp.py:37", False),
    "ilp": Variant(fused_projection_ilp, ilp_loop_plain, ILP_COUNTER,
                   SOURCE + " (fp_v3_ilp_run)",
                   "scripts/pallas_v3_ilp_exp.py:44", True),
}


def _timed_ms(fn, sync) -> float:
    """Host time of one synchronized call, in ms."""
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return (time.perf_counter() - t0) * 1e3


def ab_variant(gan, variant: str, batch: int, repeats: int = 3,
               seed: int = 0) -> dict:
    """A/B of one variant against v3 on `gan` (a deep two-deconv model) at
    `batch` images x the config's R and L: the gate, then the times."""
    var = VARIANTS[variant]
    cfg, gen = gan.cfg, gan.generator
    dev = gan.device
    rr, k = cfg.rec_rr, cfg.latent_dim
    kw = dict(rec_iters=cfg.rec_iters, rec_lr=cfg.rec_lr,
              momentum=cfg.rec_momentum)
    g = torch.Generator(device=dev).manual_seed(seed)
    clean = gan.generate(g, batch - batch // 2)
    u = torch.rand(clean[:batch // 2].shape, device=dev, generator=g)
    x = torch.cat([clean, (clean[:batch // 2] + (u - 0.5) * 0.2)
                   .clamp(0.0, 1.0)])
    z0 = torch.randn(batch, rr, k, device=dev, generator=g)
    packed = pack_generator(gen, "s2d")
    apply_s2d = make_packed_apply(packed)
    pack = pack_s2d(gen)
    x_rep = tile_restarts(from_image_space(x).reshape(batch, -1)
                          [:, packed.perm[0]], rr)
    z0_flat = z0.reshape(batch * rr, k)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    # the gate: same x and z0 through both loops, then the [B, R] losses
    with torch.no_grad():
        z_v3 = fused_projection_s2d(pack, x_rep, z0_flat, **kw)
        z_var = var.loop(pack, x_rep, z0_flat, **kw)
        ref = rec_losses(apply_s2d, z_v3, x_rep).reshape(batch, rr) \
            .cpu().numpy()
        test = rec_losses(apply_s2d, z_var, x_rep).reshape(batch, rr) \
            .cpu().numpy()
    tie = tie_aware_disagreement(ref, test)
    rel = np.abs(test - ref) / ref
    spread = ref.max(1) - ref.min(1)
    gate = dict(
        argmin_agreement=float((ref.argmin(1) == test.argmin(1)).mean()),
        **tie, best_loss_p95=best_loss_p95(ref, test),
        loss_absdiff_p95=float(np.quantile(np.abs(test - ref), 0.95)),
        loss_rel_p50=float(np.quantile(rel, 0.5)),
        loss_rel_p95=float(np.quantile(rel, 0.95)),
        best_loss_mean_v3=float(ref.min(1).mean()),
        best_loss_mean_variant=float(test.min(1).mean()),
        tie_gate_vacuous=bool((spread < tie["tau"]).mean() > 0.5),
        z_final_bit_equal=bool(torch.equal(z_v3, z_var)),
        z_final_max_abs_diff=(z_v3 - z_var).abs().max().item())
    ok = (gate["material_disagreement"] <= MATERIAL_MAX
          and gate["best_loss_p95"] <= P95_MAX
          and gate["loss_rel_p50"] <= LOSS_REL_P50_MAX
          and gate["loss_rel_p95"] <= LOSS_REL_P95_MAX
          and bool(np.isfinite(test).all()))
    if var.bit_equal:
        ok = ok and gate["z_final_bit_equal"]
    gate["ok"] = bool(ok)
    del z_v3, z_var

    # the times, in turns: the loop alone, then the whole reconstruct
    shape = tuple(cfg.image_shape)
    rec_kw = dict(rec_rr=rr, **kw)
    runs = {
        "v3": (lambda: fused_projection_s2d(pack, x_rep, z0_flat, **kw),
               make_s2d_reconstructor(gen, shape, **rec_kw)),
        variant: (lambda: var.loop(pack, x_rep, z0_flat, **kw),
                  make_s2d_reconstructor(gen, shape, loop=var.loop,
                                         **rec_kw)),
    }
    times = {name: {"loop": [], "recon": []} for name in runs}
    with torch.no_grad():
        for name, (loop, recon) in runs.items():     # warm-up
            loop()
            recon(x, z0=z0)
        for _ in range(repeats):
            for name, (loop, recon) in runs.items():
                times[name]["loop"].append(_timed_ms(loop, sync))
                times[name]["recon"].append(
                    _timed_ms(lambda: recon(x, z0=z0), sync))
    out = {"variant": variant, "batch": batch, "rr": rr,
           "rows": batch * rr, "iters": cfg.rec_iters, "repeats": repeats,
           "device": str(dev),
           "device_name": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu", "gate": gate}
    for name, t in times.items():
        loop_ms = statistics.median(t["loop"])
        recon_ms = statistics.median(t["recon"])
        out[name] = dict(loop_ms=loop_ms, recon_ms=recon_ms,
                         recon_per_s=batch / (recon_ms / 1e3),
                         loop_ms_all=t["loop"], recon_ms_all=t["recon"])
    out["recon_per_s_ratio"] = out[variant]["recon_per_s"] / \
        out["v3"]["recon_per_s"]
    return out


def main(argv=None) -> list:
    from defensegan_torch.configs import load_config
    from defensegan_torch.gan import DefenseGAN
    from defensegan_torch.utils.misc import append_jsonl, ensure_dir
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", nargs="+", choices=sorted(VARIANTS),
                    default=sorted(VARIANTS))
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cfg", default=DEFAULT_CFG,
                    help="a deep two-deconv config or a run dir (its "
                    "export is loaded when it has one, else the seeded "
                    "init serves, as in the JAX harnesses)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--results_dir", default="output/results_torch")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    gan = DefenseGAN(load_config(args.cfg), device=args.device)
    if gan.can_load():
        gan.load()
    rows = []
    for name in args.variant:
        rec = ab_variant(gan, name, args.batch, args.repeats, args.seed)
        rec["weights"] = "trained" if gan.can_load() else "seeded"
        print(json.dumps(rec), flush=True)
        rows.append(rec)
        ensure_dir(args.results_dir)
        append_jsonl(os.path.join(args.results_dir,
                                  "pallas_v3_variants.jsonl"), rec)
    for rec in rows:
        name = rec["variant"]
        print(f"{name}: {rec[name]['recon_per_s']:.2f} recon/s against v3 "
              f"{rec['v3']['recon_per_s']:.2f} "
              f"(x{rec['recon_per_s_ratio']:.3f}), gate "
              f"{'ok' if rec['gate']['ok'] else 'FAILED'}", flush=True)
    if not all(r["gate"]["ok"] for r in rows):
        raise SystemExit(1)
    return rows
