#!/usr/bin/env python3
"""z_final of the v3 kernel on seeded inputs, as a digest and a time: the
check that a change to v3's step (csrc/fused_projection_v3_step.cuh) left
its output bit for bit as it was.

The deep mnist.yml model with chip_smoke.py's seeded weights, G(z) of
seeded latents as targets, seeded z0; `--root` takes the port (and
chip_smoke.py) from another checkout, so that two versions run in one
call on one card, in turns:

    python3 scripts/torch_v3_zfinal.py --rows 512 --iters 5
    python3 scripts/torch_v3_zfinal.py --root /path/to/parent --rows 10240

Prints one JSON line: the root, rows, iters, the sha256 of z_final's
bytes, the loop's median ms of 3 (host clock around synchronized calls
after a warm-up) and the card. Needs one CUDA device.
"""

import argparse
import hashlib
import json
import os
import statistics
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_v3_zfinal: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from defensegan_torch.defense.fastgen import pack_generator
    from defensegan_torch.kernels.fused_projection_v3 import (
        fused_projection_s2d, pack_s2d)
    from defensegan_torch.models.generator import from_image_space
    gan = chip_smoke.seeded_deep_gan()
    cfg, dev = gan.cfg, gan.device
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    perm = pack_generator(gan.generator, "s2d").perm[0]
    x = from_image_space(gan.generate(gen, args.rows)).reshape(
        args.rows, -1)[:, perm]
    z0 = torch.randn(args.rows, cfg.latent_dim, device=dev, generator=gen)
    pack = pack_s2d(gan.generator)

    def run():
        return fused_projection_s2d(pack, x, z0, rec_iters=args.iters,
                                    rec_lr=cfg.rec_lr,
                                    momentum=cfg.rec_momentum)

    z = run()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({
        "root": root, "rows": args.rows, "iters": args.iters,
        "sha256": hashlib.sha256(z.cpu().numpy().tobytes()).hexdigest(),
        "ms": statistics.median(times), "ms_all": times,
        "device": torch.cuda.get_device_name(dev)}), flush=True)


if __name__ == "__main__":
    main()
