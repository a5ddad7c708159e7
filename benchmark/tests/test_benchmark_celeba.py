"""The `celeba` configuration and its cell `celeba.bulk4k`: the file as the
harness reads it, the program's generator and path at its published
widths, the counts the metrics divide by, and the program's v4
reconstructor against the plain reference at a small celeba-shaped size on
the CPU (test_benchmark_run.py runs the cell end to end)."""

import math
from functools import partial

import pytest
import torch

from benchmark import flops, spec, synthetic, weights
from benchmark.check import shape_of
from benchmark.reference.generator import (GeneratorShape, generate,
                                           weight_shapes)
from benchmark.reference.numerics import FP8, FP32
from benchmark.reference.projection import project
from benchmark.system import _nested
from bench_tiny import BENCH

CELL = "celeba.bulk4k"


def conf():
    return spec.config(BENCH, "celeba")


def test_configuration_and_traffic_load():
    c = conf()
    assert c["name"] == "celeba" and c["reduced"] == []
    assert c["path"] == "pallas_v4" and c["image_shape"] == [64, 64, 3]
    assert c["generator"] == {"latent_dim": 128, "base_hw": 4,
                              "channels": [512, 256, 128, 64],
                              "out_channels": 3, "kernel": 5, "stride": 2}
    assert c["projection"] == {"restarts": 2, "iters": 200, "lr": 10.0,
                               "momentum": 0.7}
    assert c["classifier"]["num_classes"] == 2
    assert 128 <= c["check"]["sample_images"] <= 256
    t = spec.traffic(spec.cell(BENCH, CELL)["traffic"])
    assert (t["loop"], t["images_per_request"], t["pool_images"],
            t["trace_requests"]) == ("closed_loop", 4096, 8192, 2)
    reported = {m["name"] for m in spec.cell_metrics(BENCH, CELL,
                                                     "per_layer")}
    assert {"projection_roofline", "mfu_pct.bulk",
            "loop_device_ms.bulk"} <= reported


def test_configuration_is_not_another_under_a_new_name():
    """A configuration is named by its source and its cut: no other entry
    of BENCHMARK.json has both of celeba's, and its file agrees."""
    entries = {c["name"]: c for c in BENCH["configs"]}
    mine = entries.pop("celeba")
    assert conf()["source"] == mine["source"]
    assert all((c["source"], c["reduced"]) != (mine["source"], mine["reduced"])
               for c in entries.values())


def test_program_builds_the_stated_generator_and_path():
    """The program's celeba.yml with the configuration's overrides builds
    the configuration's generator; `auto` resolves to v4 on the card and
    to the plain path on the CPU."""
    from defensegan_torch.configs import load_config
    from defensegan_torch.gan import (DefenseGAN,
                                      resolve_projection_kernel)
    c = conf()
    cfg = load_config(f"{spec.ROOT}/{c['program_config']}",
                      c["program_overrides"])
    gan = DefenseGAN(cfg, device="cpu")
    g = gan.generator
    assert dict(latent_dim=g.latent_dim, base_hw=g.base_hw,
                channels=list(g.channels), out_channels=g.out_channels,
                kernel=g.kernel, stride=2) == c["generator"]
    assert tuple(cfg.image_shape) == tuple(c["image_shape"])
    assert resolve_projection_kernel(gan, on_cuda=True) == c["path"]
    assert resolve_projection_kernel(gan, on_cuda=False) == "xla"


def test_weights_and_work():
    shape = shape_of(conf())
    assert sum(math.prod(s) for s in weight_shapes(shape).values()) == \
        5_366_659
    assert flops.forward_macs(shape) == 137_090_752
    assert flops.step_flops(shape) == 548_363_008
    assert flops.image_flops(shape, 2, 200) == 219_345_203_200


# ---- the program's v4 reconstructor against the reference, on the CPU
SMALL = GeneratorShape(16, 4, (32, 16, 8, 4), 3)     # celeba.yml, GEN_DIM 4
IMAGES, R, L = 8, 2, 3
# Tolerances, each with its reason. The program's loop rounds every
# product's operands to bf16 (2^-9 relative) and reads its final losses
# and G(z*) through the bf16 conv-packed apply; the reference runs
# float32. fp8 e4m3 operands (2^-4) are 32 times coarser.
LOSS_RTOL = 4e-3   # one bf16 ulp at 1 (2^-8) over each restart's loss:
                   # seeds 0-15 read at most 2.0e-3, fp8 down to 3.5e-4
Z_STEP = 0.3       # z* within 0.3 of the reference's own step from the
                   # draw: at L 3 the step is a few hundredths, and the
                   # gradient's bf16 rounding carries through lr 10 and
                   # momentum 0.7 (0.23 at most on seeds 0-15)
XHAT_ATOL = 3.5e-3  # G(z*) in [0, 1]: a few bf16 roundings of |t| <= 1
                    # (2^-10 each in [0, 1]); seeds 0-15 read at most
                    # 2.4e-3, fp8 at least 4.5e-3


def program_generator(w):
    from defensegan_torch.ckpt.bridge import load_flax_tree
    from defensegan_torch.models.generator import generator_for
    g = generator_for("celeba", 4, torch.bfloat16, "deep", SMALL.latent_dim)
    load_flax_tree(g, *_nested(w))
    return g.requires_grad_(False)


def gaps(w, x, z0, losses, z_star, x_hat):
    """(largest relative loss gap over every restart, largest z* offset
    over the reference's step at the same restart, largest x_hat gap
    against the reference's G at that z*) against the float32
    reference."""
    ref = project(partial(generate, w, SMALL, prec=FP32), x, z0, iters=L,
                  lr=10.0, momentum=0.7)
    rows = torch.arange(x.shape[0])
    c = torch.argmin(losses, dim=1)
    z_ref = ref.z_final[rows, c]
    step = (z_ref - z0[rows, c]).norm(dim=1)
    g_at = (generate(w, SMALL, z_star) + 1.0) * 0.5
    return (float(((losses - ref.losses).abs() / ref.losses).max()),
            float(((z_star - z_ref).norm(dim=1) / step).max()),
            float((x_hat - g_at).abs().max()))


def within(got):
    return got[0] <= LOSS_RTOL and got[1] <= Z_STEP and got[2] <= XHAT_ATOL


@pytest.mark.parametrize("seed", [0, 1])
def test_v4_reconstructor_matches_the_reference_small(seed):
    """make_v4_reconstructor on CPU tensors runs v4_loop_plain, the
    kernel's arithmetic with its bf16 roundings: every restart's final
    loss, z* and x_hat against the float32 reference from the same draws;
    the fp8 reference, one precision step below, fails the same
    comparison."""
    from defensegan_torch.kernels.fused_projection_v4 import \
        make_v4_reconstructor
    torch.manual_seed(0)
    w = weights.seeded(weight_shapes(SMALL), seed, torch.device("cpu"))
    x = torch.from_numpy(synthetic.make_synthetic(IMAGES, 64, 3, 2,
                                                  seed=seed)[0])
    z0 = torch.randn(IMAGES, R, SMALL.latent_dim,
                     generator=torch.Generator().manual_seed(seed))
    res = make_v4_reconstructor(
        program_generator(w), (64, 64, 3), rec_rr=R, rec_iters=L,
        rec_lr=10.0, momentum=0.7)(x, z0=z0)
    got = gaps(w, x, z0, res.all_losses, res.z_star, res.x_hat)
    assert within(got), got
    low = project(partial(generate, w, SMALL, prec=FP8), x, z0, iters=L,
                  lr=10.0, momentum=0.7)
    fp8 = gaps(w, x, z0, low.losses,
               low.z_final[torch.arange(IMAGES), low.best], low.x_hat)
    assert not within(fp8) and fp8[2] > XHAT_ATOL, fp8
