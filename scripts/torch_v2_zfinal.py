#!/usr/bin/env python3
"""z_final of the v2 kernel on seeded inputs, as a digest and a time: the
check that a change to v2's products (csrc/fused_projection_v2.cu,
csrc/gemm_sm90.cuh) left its output bit for bit as it was.

The committed flagship (output/gans/mnist_fast, R and L as its config),
G(z) of seeded latents as targets, seeded z0; `--root` takes the port from
another checkout, so that two versions run in one call on one card:

    python3 scripts/torch_v2_zfinal.py --rows 10 64 10240
    python3 scripts/torch_v2_zfinal.py --root /path/to/parent --rows 64

Prints one JSON line per row count: the root, rows, iters, the sha256 of
z_final's bytes, the loop's median ms of 3 (host clock around synchronized
calls after a warm-up), the card, and whether the digest is REFERENCE's
(null where none was recorded for this card and torch build). Needs one
CUDA device.
"""

import argparse
import hashlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# z_final's sha256 as the kernel gives it on these inputs (seed 0), by the
# card and torch build that gave it: (card, torch) -> {(rows, iters):
# digest}. Recorded from the dense walk of D (before the slab lists), which
# the listed walk reproduces. Another card or build has no reference until
# this script has run there for the parent checkout (--root) and the
# change in one call and the two agree.
REFERENCE = {
    ("NVIDIA H100 80GB HBM3", "2.11.0+cu128"): {
        (10, 200):
            "02316b889b87255436b09eff75b30224f98a6680e2ac3cdb120c1151ac32704c",
        (64, 200):
            "50d6d7d1320bcf1d7639626e1ee211fb5649933cbd322875e4bd147ec535321e",
        (10240, 200):
            "d506033efa4b4a84a74f2df25639de5b2b76f67b741394ede398306e0d340651"}}


def zfinal(rows: int = 64, iters: int = 200, seed: int = 0,
           root: str = ROOT) -> dict:
    """z_final of the v2 kernel on the flagship at `rows` rows: its digest,
    the loop's time and the comparison with REFERENCE (`same`: True,
    False, or None where no reference applies)."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_v2_zfinal: needs a CUDA device")
    from defensegan_torch.configs import load_config
    from defensegan_torch.gan import DefenseGAN
    from defensegan_torch.kernels.fused_projection_v2 import (
        fused_projection_dense, pack_dense)
    from defensegan_torch.models.generator import from_image_space
    run = os.path.join(root, "output", "gans", "mnist_fast")
    dev = torch.device("cuda")
    gan = DefenseGAN(load_config(run).replace(output_dir=run),
                     device=dev).load()
    cfg = gan.cfg
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = from_image_space(gan.generate(gen, rows)).reshape(rows, -1)
    z0 = torch.randn(rows, cfg.latent_dim, device=dev, generator=gen)
    pack = pack_dense(gan.generator)

    def loop():
        return fused_projection_dense(pack, x, z0, rec_iters=iters,
                                      rec_lr=cfg.rec_lr,
                                      momentum=cfg.rec_momentum)

    z = loop()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    digest = hashlib.sha256(z.cpu().numpy().tobytes()).hexdigest()
    device = torch.cuda.get_device_name(dev)
    ref = REFERENCE.get((device, torch.__version__), {}).get(
        (rows, iters)) if seed == 0 else None
    return {"rows": rows, "iters": iters, "sha256": digest,
            "ms": statistics.median(times), "ms_all": times,
            "device": device, "torch": torch.__version__,
            "same": None if ref is None else digest == ref}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--rows", type=int, nargs="+", default=[10, 64, 10240])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    for rows in args.rows:
        print(json.dumps({"root": root, **zfinal(rows, args.iters,
                                                 args.seed, root)}),
              flush=True)


if __name__ == "__main__":
    main()
