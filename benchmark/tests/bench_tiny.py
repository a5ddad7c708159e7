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


# the encoder of a tiny encoder-initialised configuration: the program's
# MNIST encoder at DISC_DIM 8 and LATENT_DIM 16
TINY_ENCODER = {"channels": [8, 16], "kernel": 5, "stride": 2, "z_dim": 16,
                "negative_slope": 0.2}


def tiny_encoder(images_per_request: int, monkeypatch, **kw):
    """`tiny` of a deep copy of mnist_fast's configuration whose projection
    starts restart 0 at the encoder (`projection.init` "encoder"), with a
    seeded encoder of channels [8, 16] and z_dim 16.

    far_share is this size's own: both sides run float32 here. Sound runs
    read restart_undone_max at most 5.8e-6 (eight seeds), a wrong E(x)
    at least 0.023 (ReLU for LeakyReLU) and 0.083 (another seed's
    weights; six seeds each). mnist_fast's 0.5 was set from bf16 runs on
    the card from random starts."""
    conf = tiny("mnist_fast", images_per_request, monkeypatch, **kw)
    conf["projection"]["init"] = "encoder"
    conf["encoder"] = copy.deepcopy(TINY_ENCODER)
    conf["program_overrides"].update(REC_INIT="encoder", DISC_DIM=8)
    conf["check"]["far_share"] = 0.005
    return conf


def encoder_stand_in(monkeypatch):
    """A test-only stand-in for the program change that an encoder cell
    needs, not the program: DefenseGAN.reconstruct, handed draws z0 under
    rec_init "encoder", writes its own E(x) (gan.encode) into restart 0 of
    a copy and projects that. The program as it stands projects z0
    whole."""
    from defensegan_torch.gan import DefenseGAN
    real = DefenseGAN.reconstruct

    def reconstruct(self, x, gen=None, *, init=None, z0=None, **kw):
        if z0 is not None and (init or self.cfg.rec_init) == "encoder":
            z0 = z0.clone()
            z0[:, 0] = self.encode(torch.as_tensor(x, device=self.device))
        return real(self, x, gen, init=init, z0=z0, **kw)

    monkeypatch.setattr(DefenseGAN, "reconstruct", reconstruct)
