"""The plain reference against the port at a tiny size, on the CPU, in
float32: the generators, flax's transpose convolution by its definition,
classifier A, the projection and the detector's threshold."""

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import classifier as ref_classifier
from benchmark.reference import detector as ref_detector
from benchmark.reference import generator as ref_generator
from benchmark.reference.numerics import FP8, fp8_round
from benchmark.reference.projection import project
from benchmark.system import _nested

SHAPES = {"wide": ref_generator.GeneratorShape(16, 14, (8,), 1),
          "deep": ref_generator.GeneratorShape(16, 7, (16, 8), 1)}


def port_generator(arch, w):
    from defensegan_torch.ckpt.bridge import load_flax_tree
    from defensegan_torch.models.generator import Generator
    s = SHAPES[arch]
    g = Generator(latent_dim=s.latent_dim, base_hw=s.base_hw,
                  channels=s.channels, out_channels=s.out_channels)
    load_flax_tree(g, *_nested(w))
    return g.requires_grad_(False)


def seeded(arch, seed=3):
    return weights.seeded(ref_generator.weight_shapes(SHAPES[arch]), seed,
                          torch.device("cpu"))


@pytest.mark.parametrize("arch", sorted(SHAPES))
def test_generator_matches_port(arch):
    w = seeded(arch)
    z = torch.randn(6, 16, generator=torch.Generator().manual_seed(1))
    got = ref_generator.generate(w, SHAPES[arch], z)
    want = port_generator(arch, w)(z)
    assert got.shape == (6, 28, 28, 1)
    assert torch.allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("h,cin,cout", [(7, 8, 3), (14, 4, 1)])
def test_deconv_is_flax_definition(h, cin, cout):
    g = torch.Generator().manual_seed(h)
    x = torch.randn(2, cin, h, h, generator=g)
    k = torch.randn(5, 5, cin, cout, generator=g)
    got = ref_generator.deconv(x, k, 2)
    assert got.shape == (2, cout, 2 * h, 2 * h)
    assert torch.allclose(got, ref_generator.deconv_literal(x, k, 2),
                          atol=1e-5)


def test_classifier_matches_port():
    from defensegan_torch.ckpt.bridge import load_flax_tree
    from defensegan_torch.models.classifiers import build_classifier
    w = weights.seeded(ref_classifier.weight_shapes(), 5, torch.device("cpu"))
    clf = build_classifier("A")
    load_flax_tree(clf, _nested(w)[0])
    x = torch.rand(4, 28, 28, 1, generator=torch.Generator().manual_seed(2))
    assert torch.allclose(ref_classifier.logits(w, x), clf(x), atol=1e-5)


@pytest.mark.parametrize("arch", sorted(SHAPES))
def test_projection_matches_port(arch):
    from defensegan_torch.defense.project import reconstruct
    w = seeded(arch)
    g = torch.Generator().manual_seed(4)
    x = torch.rand(3, 28, 28, 1, generator=g)
    z0 = torch.randn(3, 2, 16, generator=g)
    ref = project(lambda z: ref_generator.generate(w, SHAPES[arch], z), x,
                  z0, iters=6, lr=10.0, momentum=0.7)
    port = reconstruct(port_generator(arch, w), x, z0, rec_iters=6,
                       rec_lr=10.0, momentum=0.7)
    assert torch.allclose(ref.losses, port.all_losses, rtol=1e-4)
    assert torch.equal(torch.argmin(ref.losses, 1),
                       torch.argmin(port.all_losses, 1))
    assert torch.allclose(ref.x_hat, port.x_hat, atol=1e-4)
    best = ref.z_final[torch.arange(3), ref.best]
    assert torch.allclose(best, port.z_star, atol=1e-4)


def test_detector_matches_port():
    from defensegan_torch.defense.pipeline import DefendedPipeline
    errs = np.random.RandomState(0).gamma(2.0, 0.01, size=101)
    pipe = DefendedPipeline(gan=None, logits_fn=None, fpr=0.05)
    pipe._center = float(np.median(errs))
    center, threshold = ref_detector.calibrate(errs, 0.05)
    pipe._threshold = float(np.quantile(pipe._scores(errs), 0.95))
    assert center == pipe._center and threshold == pipe._threshold


def test_fp8_rounding_is_coarse_and_scaled():
    t = torch.linspace(-3.0, 3.0, 1001)
    q = fp8_round(t)
    assert q.abs().max() == t.abs().max()
    rel = ((q - t).abs() / t.abs().clamp_min(1e-3)).max()
    assert 1e-2 < rel < 0.07          # e4m3: 3 mantissa bits
    z = torch.randn(4, 16, requires_grad=True)
    (FP8.operand(z) * 2).sum().backward()
    assert torch.equal(z.grad, torch.full_like(z, 2.0))
