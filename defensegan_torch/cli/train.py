"""GAN training / test-mode CLI (port of the JAX package's cli/train.py).

Reference parity: train.py of kabkabm/defensegan:
  python train_torch.py --cfg defensegan_torch/configs/gans/mnist.yml --is_train
trains the WGAN-GP; without --is_train it loads the run's weight export and
writes a sample grid and an original | reconstruction grid of test images
(the reference's test mode). --train_encoder trains the amortized-inversion
encoder after training, or on its own against the run's trained generator.

Data-parallel training: under torchrun (one process per GPU)
  torchrun --nproc_per_node N train_torch.py --is_train --cfg ...
each rank joins the NCCL group (gloo with --device cpu), trains on its
share of every global batch and rank 0 writes (DefenseGAN.train); a plain
`python train_torch.py` is one process, as before.

Runs on the card unless --device names another device. Training resumes
from the run's latest torch checkpoint (<output_dir>/checkpoints/<step>.pt)
up to TRAIN_ITERS; every save also writes the weight export that test mode,
whitebox_torch.py and blackbox_torch.py load.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from defensegan_torch.cli.common import (add_cfg_args, cfg_from_args,
                                         device_from_args, load_data,
                                         load_gan)
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.parallel.distributed import initialize_distributed
from defensegan_torch.utils.misc import fold_seed, generator_for
from defensegan_torch.utils.visualize import save_images, save_images_files


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    add_cfg_args(ap)
    ap.add_argument("--is_train", action="store_true",
                    help="train the GAN (otherwise: test mode)")
    ap.add_argument("--num_recs", type=int, default=16,
                    help="test mode: how many test images to reconstruct")
    ap.add_argument("--save_recs_files", action="store_true",
                    help="test mode: also write each original and "
                    "reconstruction as its own PNG under <output_dir>/recs/ "
                    "(labels in the file names)")
    ap.add_argument("--train_encoder", action="store_true",
                    help="train the amortized-inversion encoder E(x) -> z "
                    "against the trained generator and write it into the "
                    "run's weight export (enables REC_INIT=encoder*); after "
                    "--is_train training, or on its own against the run's "
                    "export")
    return ap


def _print_encoder(m: dict) -> None:
    print(f"encoder done in {m['wall_s']:.2f}s: img_mse={m['img_mse']:.5f} "
          f"z_cycle={m['z_cycle']:.4f}")


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = cfg_from_args(args)
    device = device_from_args(args)
    ds = load_data(cfg)

    if args.is_train:
        _, world = initialize_distributed(
            "gloo" if device.type == "cpu" else "nccl")
        if world > 1 and device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        gan = DefenseGAN(cfg, device=device)
        if gan.can_restore():
            gan.restore()
            print(f"resuming from checkpoint step {gan.step}")
        elif gan.can_load():
            raise SystemExit(
                f"{cfg.output_dir} has a weight export but no training "
                "checkpoint to resume from (checkpoints/<step>.pt): train "
                "into a new --output_dir")
        # uint8 stays uint8 on the device, normalized per minibatch
        x_train, _ = ds.load_u8("train")
        print(f"training {cfg.type} WGAN-GP on {x_train.shape[0]} images "
              f"up to step {cfg.train_iters} on {device}"
              + (f" (one of {world} ranks)" if world > 1 else ""))
        out = gan.train(x_train)
        print(f"done; checkpoints, export and samples under "
              f"{cfg.output_dir}")
        if args.train_encoder:
            out["encoder"] = gan.train_encoder(x_train)
            _print_encoder(out["encoder"])
        return out

    gan = load_gan(cfg, device, require_trained=True)
    if args.train_encoder:
        x_train, _ = ds.load_u8("train")
        print(f"training encoder on {x_train.shape[0]} images for "
              f"{cfg.encoder_train_iters} steps (generator frozen at step "
              f"{gan.step})")
        m = gan.train_encoder(x_train)
        _print_encoder(m)
        return {"encoder": m}

    # test mode: sample grid + test reconstructions
    seed = fold_seed(cfg.seed, 100)
    path = gan.save_samples(os.path.join(cfg.output_dir, "test_samples.png"))
    print(f"wrote {path}")
    x_test, y_test = ds.load("test")
    x = x_test[:args.num_recs]
    res = gan.reconstruct(x, generator_for(seed, device))
    x_hat = res.x_hat.float().cpu().numpy()
    pair = np.stack([x, x_hat], axis=1).reshape((-1,) + x.shape[1:])
    path = save_images(pair, os.path.join(cfg.output_dir,
                                          "test_reconstructions.png"),
                       grid=(args.num_recs, 2))
    loss = res.loss.float().cpu().numpy()
    print(f"wrote {path} (rows: original | reconstruction); mean rec loss "
          f"{float(loss.mean()):.5f} [{gan.last_kernel}]")
    if args.save_recs_files:
        recs_dir = os.path.join(cfg.output_dir, "recs")
        labels = np.asarray(y_test[:args.num_recs]).tolist()
        save_images_files(x, recs_dir, prefix="orig", labels=labels)
        save_images_files(x_hat, recs_dir, prefix="rec", labels=labels)
        print(f"wrote {2 * len(x)} per-image PNGs under {recs_dir}/")
    return {"rec_loss": loss, "last_kernel": gan.last_kernel,
            "step": gan.step}


if __name__ == "__main__":
    main()
