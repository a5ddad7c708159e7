"""A cell at a size the CPU tests can hold: the configurations' own
pipeline and check, with a narrow generator, few restarts and steps,
float32 (the program's plain paths on the CPU), and few images."""

from __future__ import annotations

import copy

import torch

from benchmark import harness, spec

BENCH = spec.load_benchmark()


def tiny(config: str, images_per_request: int, monkeypatch,
         sample_images: int = 16):
    """Patch spec so that every cell of `config` runs tiny; returns the
    configuration dict (the tests may change it further)."""
    conf = copy.deepcopy(spec.config(BENCH, config))
    deep = len(conf["generator"]["channels"]) > 1
    conf["weights"] = {"kind": "seeded"}
    # on the CPU the program resolves `auto` to its plain per-topology path
    conf["path"] = "xla" if deep else "packed"
    conf["generator"].update(latent_dim=16,
                             channels=[16, 8] if deep else [8])
    conf["program_overrides"].update(
        LATENT_DIM=16, GEN_DIM=8 if deep else 4, REC_RR=2, REC_ITERS=5,
        COMPUTE_DTYPE="float32")
    conf["projection"].update(restarts=2, iters=5)
    conf["pipeline"]["calibration_images"] = 32
    conf["check"]["sample_images"] = sample_images
    traffic = {"loop": "closed_loop",
               "images_per_request": images_per_request,
               "pool_images": 64, "trace_requests": 2}
    monkeypatch.setattr(spec, "config", lambda b, n, root=None: conf)
    monkeypatch.setattr(spec, "traffic", lambda n: traffic)
    monkeypatch.setattr(harness, "PAD_ROWS", 256)
    return conf


def run(cell: str, seed: int = 2 ** 31 + 77, seconds: float = 0.2,
        trace: bool = False):
    import time
    return harness.run_cell(BENCH, spec.cell(BENCH, cell), seed, seconds,
                            trace, torch.device("cpu"), time.perf_counter())


def configs():
    """Every configuration of BENCHMARK.json, by name, as committed."""
    return {c["name"]: spec.config(BENCH, c["name"]) for c in BENCH["configs"]}
