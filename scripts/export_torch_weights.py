#!/usr/bin/env python
"""Export a trained run's weights as plain numpy for the PyTorch port.

The port (`defensegan_torch`) reads no orbax checkpoint: this script
restores a run with the JAX package on the CPU and writes

    <run>/export/<step>.npz    generator params + batch stats and, when the
                               run has one, the encoder params, each array
                               under its flax path, e.g.
                               "generator/params/fc_in/kernel",
                               "generator/batch_stats/bn_in/mean",
                               "encoder/params/fc_z/kernel"
    <run>/export/<step>.json   manifest: step, source checkpoints, config

`defensegan_torch.ckpt.bridge` maps these trees onto the port's modules.

Run (defaults export the committed flagship, mnist_fast step 20000):

    JAX_PLATFORMS=cpu python scripts/export_torch_weights.py \
        [--run output/gans/mnist_fast] [--step 20000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from defensegan_tpu.ckpt import latest_step  # noqa: E402
from defensegan_tpu.configs import load_config  # noqa: E402
from defensegan_tpu.gan import DefenseGAN  # noqa: E402


def flatten_tree(tree, prefix: str) -> dict:
    """{'a': {'b': x}} -> {'prefix/a/b': np.asarray(x)} (float32 kept)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten_tree(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def export_arrays(run_dir: str, step=None):
    """Restore the run (and its encoder, if any) -> (arrays, manifest)."""
    cfg = load_config(run_dir)
    cfg = cfg.replace(output_dir=run_dir)
    gan = DefenseGAN(cfg)
    step = step if step is not None else latest_step(run_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {run_dir}")
    gan.load(step)
    arrays = {}
    arrays.update(flatten_tree(gan.state.gen_params, "generator/params"))
    arrays.update(flatten_tree(gan.state.gen_stats,
                               "generator/batch_stats"))
    sources = {"generator": os.path.join(run_dir, "checkpoints", str(step))}
    if latest_step(gan.encoder_dir) is not None:
        gan.load_encoder()
        arrays.update(flatten_tree(gan.enc_params, "encoder/params"))
        sources["encoder"] = os.path.join(
            gan.encoder_dir, "checkpoints", str(latest_step(gan.encoder_dir)))
    manifest = {"step": int(step), "sources": sources,
                "config": cfg.to_yaml_dict(),
                "arrays": {k: list(v.shape)
                           for k, v in sorted(arrays.items())}}
    return arrays, manifest


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", default="output/gans/mnist_fast",
                    help="trained run dir (holds cfg.yml + checkpoints/)")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    args = ap.parse_args(argv)
    arrays, manifest = export_arrays(args.run, args.step)
    out_dir = os.path.join(args.run, "export")
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, str(manifest["step"]))
    np.savez(base + ".npz", **arrays)
    with open(base + ".json", "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    n = sum(v.size for v in arrays.values())
    print(json.dumps({"npz": base + ".npz", "arrays": len(arrays),
                      "params": int(n)}))


if __name__ == "__main__":
    main()
