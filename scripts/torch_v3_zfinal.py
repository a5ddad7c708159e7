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
after a warm-up), the card, and whether the digest is REFERENCE's (null
where no reference was recorded for this card and torch build). Needs one
CUDA device. chip_smoke.py phase 11 runs `zfinal` at both shapes and fails
unless both digests are the reference's.
"""

import argparse
import hashlib
import json
import os
import statistics
import sys
import time

# z_final's sha256 as the v3 kernel gives it on these inputs, by the card
# and torch build that gave it: (card, torch) -> {(rows, iters): digest}.
# The seeded inputs go through torch's generators and cuDNN, so another
# card or build has no reference until one is recorded: run this script
# for the parent checkout (--root) and the change in one call, and add
# the digests here when the two agree.
REFERENCE = {
    ("NVIDIA H100 80GB HBM3", "2.11.0+cu128"): {
        (512, 5):
            "c99c0f18f8321533acb91c0642f3a89dbc3d23bbfd549802de507e4bb4b4e232",
        (10240, 200):
            "ecbd49630d795926ea841919273a280df15bbd9a6c988e72e01f2d6f232d469e"}}


def zfinal(rows: int = 512, iters: int = 5, seed: int = 0,
           seeded_deep_gan=None) -> dict:
    """z_final of the v3 kernel on the seeded inputs: its digest, the
    loop's time and the comparison with REFERENCE (`same`: True, False,
    or None where no reference applies). seeded_deep_gan: the model's
    maker (default chip_smoke.py's)."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_v3_zfinal: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if seeded_deep_gan is None:
        import chip_smoke
        seeded_deep_gan = chip_smoke.seeded_deep_gan
    from defensegan_torch.defense.fastgen import pack_generator
    from defensegan_torch.kernels.fused_projection_v3 import (
        fused_projection_s2d, pack_s2d)
    from defensegan_torch.models.generator import from_image_space
    gan = seeded_deep_gan()
    cfg, dev = gan.cfg, gan.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    perm = pack_generator(gan.generator, "s2d").perm[0]
    x = from_image_space(gan.generate(gen, rows)).reshape(rows, -1)[:, perm]
    z0 = torch.randn(rows, cfg.latent_dim, device=dev, generator=gen)
    pack = pack_s2d(gan.generator)

    def run():
        return fused_projection_s2d(pack, x, z0, rec_iters=iters,
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
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    print(json.dumps({"root": root, **zfinal(args.rows, args.iters,
                                               args.seed)}), flush=True)


if __name__ == "__main__":
    main()
