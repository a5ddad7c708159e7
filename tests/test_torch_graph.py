"""The CUDA graph that DefenseGAN.reconstruct replays for a call that
fits one row tile, against the same call run eagerly, on the card.

Marked `cuda`: they skip without an NVIDIA GPU (the kernels build with
nvcc at first use). This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_graph.py

The eager call is the same call under a torch.profiler, which the graph
never serves. Graph and eager run the same kernels on the same inputs,
so they agree bit for bit. Tiny generators (GEN_DIM 4, latent 32) on
each fused loop a serve request can take: v2 (wide MNIST), v3 (deep
MNIST), v4 (deep CelebA); encoders at DISC_DIM 4.
"""

import collections

import pytest
import torch

from defensegan_torch.configs import Config
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.kernels import build
from defensegan_torch.models import encoder_for

RR, ITERS, LATENT = 2, 5, 32
# (dataset, generator arch, init) -> the loop _resolve picks
CASES = {"v2.encoder": ("mnist", "wide", "encoder"),
         "v2.random": ("mnist", "wide", "random"),
         "v3.encoder": ("mnist", "deep", "encoder"),
         "v4.random": ("celeba", "deep", "random")}
IMAGES = {"mnist": dict(image_size=28, channels=1),
          "celeba": dict(image_size=64, channels=3)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc)")
    return torch.device("cuda")


def _gan(dev, tmp_path, dataset, arch):
    cfg = Config(type=dataset, gen_arch=arch, gen_dim=4, disc_dim=4,
                 latent_dim=LATENT, rec_rr=RR, rec_iters=ITERS,
                 output_dir=str(tmp_path), **IMAGES[dataset])
    gan = DefenseGAN(cfg, device=dev)
    gan.encoder = encoder_for(
        dataset, 4, z_dim=LATENT, dtype=gan.dtype,
        gen=torch.Generator().manual_seed(1)).to(dev).requires_grad_(False)
    gan.weights_changed()
    return gan


def _inputs(gan, batch, seed, init):
    """Images in [0, 1] and a table; under encoder init restart 0 is NaN,
    so the encoder starts it."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((batch,) + tuple(gan.cfg.image_shape), generator=g)
    z0 = torch.randn((batch, RR, LATENT), generator=g)
    if init != "random":
        z0[:, 0] = float("nan")
    return x.to(gan.device), z0.to(gan.device)


def _eager(gan, x, z0, init):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        return gan.reconstruct(x, z0=z0, init=init)


def _launches(call):
    before = collections.Counter(build.LAUNCHES)
    out = call()
    torch.cuda.synchronize()
    return out, collections.Counter(build.LAUNCHES) - before


def _assert_equal(got, want):
    for field in got._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_replay_matches_eager(cuda_device, tmp_path, case):
    """Two calls of one shape: the first captures, both replay. Each
    equals the eager call bit for bit (the first's result survives the
    second's replay), and each call adds its library launches to
    build.LAUNCHES as the eager call does (the first call's warm-up run
    and capture add none)."""
    dataset, arch, init = CASES[case]
    gan = _gan(cuda_device, tmp_path, dataset, arch)
    a = _inputs(gan, 3, 0, init)
    b = _inputs(gan, 3, 1, init)
    got_a, captured = _launches(
        lambda: gan.reconstruct(a[0], z0=a[1], init=init))
    got_b, replayed = _launches(
        lambda: gan.reconstruct(b[0], z0=b[1], init=init))
    assert len(gan._graphs) == 1
    want_b, eager = _launches(lambda: _eager(gan, *b, init))
    assert replayed == eager == captured and sum(eager.values()) > 0
    _assert_equal(got_a, _eager(gan, *a, init))
    _assert_equal(got_b, want_b)
    assert torch.isfinite(got_b.x_hat).all()


@pytest.mark.cuda
def test_rows_past_one_tile_run_eagerly(cuda_device, tmp_path):
    gan = _gan(cuda_device, tmp_path, "mnist", "wide")
    x, z0 = _inputs(gan, 40, 0, "random")          # 80 rows
    gan.reconstruct(x, z0=z0, init="random")
    assert not gan._graphs


@pytest.mark.cuda
def test_weights_changed_drops_the_graphs(cuda_device, tmp_path):
    gan = _gan(cuda_device, tmp_path, "mnist", "wide")
    x, z0 = _inputs(gan, 1, 0, "encoder")
    before = gan.reconstruct(x, z0=z0, init="encoder")
    assert gan._graphs
    with torch.no_grad():
        for p in gan.encoder.parameters():
            p.mul_(0.5)
    gan.weights_changed()
    assert not gan._graphs
    got = gan.reconstruct(x, z0=z0, init="encoder")
    _assert_equal(got, _eager(gan, x, z0, "encoder"))
    assert not torch.equal(got.z_star, before.z_star)
