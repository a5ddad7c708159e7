#!/usr/bin/env python3
"""How far the v4 kernel's z_final drifts from its plain version, row by
row, beside the plain version's own float32-against-float64 drift.

The numbers behind chip_smoke.py's control-relative row bounds for v4
(`v4_row_bounds`). For each 64x64 config (celeba.yml, celeba_wide.yml,
imagenet64.yml at full width, seeded weights), each seed and 128 and 512
rows, one projection step (--iters) on G(z) targets; one JSON line each:
the median and the worst row's error relative to its step for kernel
against plain version, plain float32 against plain float64 (the control),
and their ratios.

--seeding also prints, for celeba.yml, what the two seedings of
chip_smoke.py::seeded_gan give the loop to work on: the pixel spread of
G(z) and the mean loss before and after L = 200 steps on 128 images x R 2,
with unit-centred BatchNorm statistics and with running ones.

Needs one CUDA device:

    python3 scripts/torch_v4_row_drift.py [--iters 1] [--seeds 2468,1,2] \\
        [--seeding]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("celeba", "celeba_wide", "imagenet64")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--seeds", default="2468,1,2")
    ap.add_argument("--seeding", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import CFG_DIR, row_errors, seeded_celeba_gan, seeded_gan
    from defensegan_torch.defense.fastgen import (make_packed_apply,
                                                  pack_generator)
    from defensegan_torch.defense.project import rec_losses
    from defensegan_torch.kernels.fused_projection_v4 import (
        fused_projection_v4, pack_v4, v4_loop_plain, x_rows)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for cfg_name in CONFIGS:
        gan = seeded_celeba_gan(cfg_name)
        cfg, pack = gan.cfg, pack_v4(gan.generator)
        kw = dict(rec_iters=args.iters, rec_lr=cfg.rec_lr,
                  momentum=cfg.rec_momentum)
        for seed in (int(s) for s in args.seeds.split(",")):
            g = torch.Generator(device=dev).manual_seed(seed)
            for rows in (128, 512):
                x = x_rows(pack, gan.generate(g, rows) * 2.0 - 1.0)
                z0 = torch.randn(rows, cfg.latent_dim, device=dev,
                                 generator=g)
                zk = fused_projection_v4(pack, x, z0, **kw)
                torch.cuda.synchronize()
                zp = v4_loop_plain(pack, x, z0, **kw)
                z64 = v4_loop_plain(pack, x, z0,
                                    product_dtype=torch.float64, **kw)
                e, c = row_errors(zk, zp, z0), row_errors(zp, z64, z0)
                print(json.dumps({
                    "config": cfg_name, "seed": seed, "rows": rows,
                    "iters": args.iters, "moved": e["moved"],
                    "kernel_row_p50": e["row_rel_p50"],
                    "kernel_row_max": e["row_rel_max"],
                    "control_row_p50": c["row_rel_p50"],
                    "control_row_max": c["row_rel_max"],
                    "p50_ratio": e["row_rel_p50"] / c["row_rel_p50"],
                    "max_ratio": e["row_rel_max"] / c["row_rel_max"]}),
                    flush=True)
    if args.seeding:
        path = os.path.join(CFG_DIR, "celeba.yml")
        for running in (False, True):
            gan = seeded_gan(path, running_stats=running)
            cfg, pack = gan.cfg, pack_v4(gan.generator)
            apply_conv = make_packed_apply(pack_generator(gan.generator,
                                                          "conv"))
            g = torch.Generator(device=dev).manual_seed(2468)
            x_img = gan.generate(g, 128)
            x = x_rows(pack, x_img * 2.0 - 1.0).repeat_interleave(2, dim=0)
            x_flat = (x_img * 2.0 - 1.0).reshape(128, -1) \
                .repeat_interleave(2, dim=0)
            z0 = torch.randn(256, cfg.latent_dim, device=dev, generator=g)
            zk = fused_projection_v4(pack, x, z0, rec_iters=cfg.rec_iters,
                                     rec_lr=cfg.rec_lr,
                                     momentum=cfg.rec_momentum)
            with torch.no_grad():
                before = rec_losses(apply_conv, z0, x_flat).mean().item()
                after = rec_losses(apply_conv, zk, x_flat).mean().item()
            print(json.dumps({
                "config": "celeba", "running_stats": running,
                "pixel_std_over_latents": x_img.std(0).mean().item(),
                "pixel_std": x_img.std().item(),
                "loss_at_z0": before, "loss_after_L200": after,
                "z_moved": (zk - z0).abs().max().item()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
