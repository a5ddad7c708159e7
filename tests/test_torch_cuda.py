"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip without an NVIDIA GPU (the kernels build with
nvcc at first use). This file imports neither JAX nor the JAX package, so
it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py sets JAX up for the CPU suite.) The
widths here (latent 32; wide F 1568; deep c0 8, ca 16; the 64x64 stacks at
GEN_DIM 4) exercise the wrappers' padding of k, F and the deep loops'
channels to the kernels' 64-wide tiles -- for v4 every run of an
interleaved level is padded to 64 on its own, so that no 64 channels of a
tile straddle two runs; chip_smoke.py checks the full widths, where only
the out level is padded. The grid conv alone (kernels/conv3x3.py) runs at
published widths and at the edges of its design (CONV_EDGES), and so does
the GEMM that carries every other product (kernels/gemm.py, GEMM_EDGES).
The experiments' kernels (defensegan_torch/experiments/) close the file:
the stream64 level at its published widths, the three v3 variants at the
narrow deep model's (v3p's pad column of h1 kept at zero; ilp's ping-pong
conv A alone against v3's schedule at conv A's published widths), the ten
construct probes at their script's shapes and the cut steps at the narrow
deep model's widths.
Tolerances are chip_smoke.py's elementwise bounds: kernel and plain
version differ only in float32 summation order, which flips a bf16
rounding (2^-8 relative) of an intermediate now and then, carried forward
by the lr = 10 momentum steps.
"""

import ctypes

import numpy as np
import pytest
import torch

from defensegan_torch.experiments import fused_projection_v3p as v3p
from defensegan_torch.experiments import stream64_probe as sp
from defensegan_torch.experiments import v3_diag, v3_diag2
from defensegan_torch.experiments.v3_ilp import (CONV_COUNTER, conv_a,
                                                 fused_projection_ilp)
from defensegan_torch.experiments.v3_packed import run_packed
from defensegan_torch.experiments.v3_variants import VARIANTS
from defensegan_torch.kernels import build
from defensegan_torch.kernels.conv3x3 import (COUNTER, MODES, conv3x3,
                                              conv3x3_plain, rounding_excess,
                                              to_fine)
from defensegan_torch.kernels.fused_projection_v2 import (
    dense_loop_plain, fused_projection_dense, pack_dense, pad_targets)
from defensegan_torch.kernels.fused_projection_v2i import (
    dense_int8_loop_plain, fused_projection_dense_int8, pack_dense_int8)
from defensegan_torch.kernels.fused_projection_v3 import (
    CUTS, ENTRY, FUSED_COUNTER, FUSED_ENTRY, fused_projection_s2d, pack_s2d,
    s2d_loop_plain, s2d_state)
from defensegan_torch.kernels.fused_projection_v4 import (
    fused_projection_v4, pack_v4, v4_loop_plain, x_rows)
from defensegan_torch.kernels.gemm import COUNTER as GEMM_COUNTER
from defensegan_torch.kernels.gemm import gemm, gemm_plain, split_k_for
from defensegan_torch.kernels.gemm import rounding_excess as gemm_excess
from defensegan_torch.kernels.loop import ONE_TILE_COUNTER
from defensegan_torch.models.generator import Generator, generator_for

LR, MOM = 10.0, 0.7
TOL = {1: 4e-3, 5: 2e-2}
V4 = "fused_projection_v4"
# v4's topologies: (dataset, arch, image size, channels, levels)
V4_TOPOLOGIES = {"celeba_deep": ("celeba", "deep", 64, 3, 4),
                 "celeba_wide": ("celeba", "wide", 64, 3, 3),
                 "mnist_deep": ("mnist", "deep", 28, 1, 2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc)")
    return torch.device("cuda")


def _case(dev, n=128, arch="wide"):
    tg = generator_for("mnist", 4, torch.bfloat16, arch, 32,
                       gen=torch.Generator().manual_seed(0))
    tg = tg.to(dev).requires_grad_(False)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(np.tanh(rng.randn(n, 784)).astype(np.float32))
    z0 = torch.from_numpy(rng.randn(n, 32).astype(np.float32))
    return tg, x.to(dev), z0.to(dev)


def _three_launch_v3(pack, x, z0, **kw):
    """v3 with conv B's section as three launches (fp_v3_run), whatever
    the pack's shapes."""
    return fused_projection_s2d(pack, x, z0,
                                state=s2d_state(pack, entry=ENTRY), **kw)


def _kernel(name, tg):
    """(pack, wrapper, plain version, bf16 base pack, the build.LAUNCHES
    key of the wrapper's calls) of a kernel. On the deep generator v3
    takes its fused conv B entry, counted under its own key;
    fused_projection_v3.three_launch is v3's three-launch entry on it."""
    if name == "fused_projection_v3":
        return (pack_s2d(tg), fused_projection_s2d, s2d_loop_plain, None,
                FUSED_COUNTER)
    if name == "fused_projection_v3.three_launch":
        return (pack_s2d(tg), _three_launch_v3, s2d_loop_plain, None,
                "fused_projection_v3")
    if name == "fused_projection_v2":
        pack = pack_dense(tg)
        return pack, fused_projection_dense, dense_loop_plain, pack, name
    pack = pack_dense_int8(tg)
    return (pack, fused_projection_dense_int8, dense_int8_loop_plain,
            pack.base, name)


KERNELS = ["fused_projection_v2", "fused_projection_v2i",
           "fused_projection_v3", "fused_projection_v3.three_launch"]


def _arch(name):
    return "deep" if name.startswith("fused_projection_v3") else "wide"


def _targets(base, x):
    """The plain version's x: v2 / v2i pad it to P; v3 takes it as is."""
    return x if base is None else pad_targets(base, x, x.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("name", KERNELS)
def test_kernel_matches_plain(cuda_device, name, steps):
    tg, x, z0 = _case(cuda_device, arch=_arch(name))
    pack, run, plain, base, key = _kernel(name, tg)
    before = build.LAUNCHES[key]
    got = run(pack, x, z0, rec_iters=steps, rec_lr=LR, momentum=MOM,
              chunk=64)
    torch.cuda.synchronize()
    assert build.LAUNCHES[key] == before + 2     # two 64-row chunks
    ref = plain(pack, _targets(base, x), z0, rec_iters=steps, rec_lr=LR,
                momentum=MOM)
    moved = (ref - z0).abs().max().item()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= TOL[steps] * moved


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNELS)
def test_kernel_pads_rows_and_chunks_exactly(cuda_device, name):
    """200 rows (not a multiple of the 64-row tile) are padded and
    cropped; a row's result does not depend on the other rows, so 64-row
    chunks (the last one short after padding) equal one chunk bit for
    bit, and both match the plain version."""
    tg, x, z0 = _case(cuda_device, n=200, arch=_arch(name))
    pack, run, plain, base, key = _kernel(name, tg)
    kw = dict(rec_iters=5, rec_lr=LR, momentum=MOM)
    before = build.LAUNCHES[key]
    one = run(pack, x, z0, **kw)
    one_tile_before = build.LAUNCHES[ONE_TILE_COUNTER]
    chunked = run(pack, x, z0, chunk=64, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES[key] == before + 1 + 4   # 256 padded rows
    # v3's 64-row chunks run conv A in the one-tile form
    assert build.LAUNCHES[ONE_TILE_COUNTER] == one_tile_before + \
        (4 if name.startswith("fused_projection_v3") else 0)
    assert one.shape == (200, 32) and torch.equal(one, chunked)
    ref = plain(pack, _targets(base, x), z0, **kw)
    moved = (ref - z0).abs().max().item()
    assert (one - ref).abs().max().item() <= TOL[5] * moved


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    tg, x, z0 = _case(cuda_device)
    with pytest.raises(ValueError, match="multiple of 64"):
        fused_projection_dense(pack_dense(tg), x, z0, rec_iters=1,
                               rec_lr=LR, momentum=MOM, chunk=100)
    cpu_pack = pack_dense(tg.to("cpu"))
    with pytest.raises(ValueError, match="one device"):
        fused_projection_dense(cpu_pack, x[:64], z0[:64], rec_iters=1,
                               rec_lr=LR, momentum=MOM)


def _v4_case(dev, topology, n=128):
    dataset, arch, size, ch, levels = V4_TOPOLOGIES[topology]
    tg = generator_for(dataset, 4, torch.bfloat16, arch, 32,
                       gen=torch.Generator().manual_seed(0))
    tg.requires_grad_(False)
    # BatchNorm statistics away from the identity, from a seeded generator
    gb = torch.Generator().manual_seed(1)
    for name, mod in tg.named_modules():
        if name.startswith("bn_"):
            mod.scale.copy_(1.0 + 0.3 * torch.randn(mod.scale.shape,
                                                    generator=gb))
            mod.bias.copy_(0.2 * torch.randn(mod.bias.shape, generator=gb))
            mod.mean.copy_(0.2 * torch.randn(mod.mean.shape, generator=gb))
            mod.var.copy_(0.5 + torch.rand(mod.var.shape, generator=gb))
    pack = pack_v4(tg.to(dev))
    assert len(pack.levels) == levels
    rng = np.random.RandomState(0)
    x = torch.from_numpy(np.tanh(rng.randn(n, size, size, ch))
                         .astype(np.float32))
    z0 = torch.from_numpy(rng.randn(n, 32).astype(np.float32))
    return pack, x_rows(pack, x.to(dev)), z0.to(dev)


def _row_rel(got, ref, z0):
    """Each row's error relative to its own step."""
    return ((got - ref).abs().amax(1) / (ref - z0).abs().amax(1)).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("topology", list(V4_TOPOLOGIES))
def test_v4_kernel_matches_plain(cuda_device, topology, steps):
    """Row by row, as chip_smoke.py holds the deep loops: with one relu
    mask per level a pre-activation within float32 noise of zero takes the
    other side of its relu in a few rows, so the median row is held to the
    elementwise bound and the worst row to 5e-2 (L = 1) / 1e-1 (L = 5)."""
    pack, x, z0 = _v4_case(cuda_device, topology)
    kw = dict(rec_iters=steps, rec_lr=LR, momentum=MOM)
    before = build.LAUNCHES[V4]
    got = fused_projection_v4(pack, x, z0, chunk=64, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES[V4] == before + 2       # two 64-row chunks
    ref = v4_loop_plain(pack, x, z0, **kw)
    assert torch.isfinite(got).all()
    rel = _row_rel(got, ref, z0)
    assert rel.median().item() <= TOL[steps]
    assert rel.max().item() <= {1: 5e-2, 5: 1e-1}[steps]


@pytest.mark.cuda
@pytest.mark.parametrize("topology", list(V4_TOPOLOGIES))
def test_v4_kernel_pads_rows_and_chunks_exactly(cuda_device, topology):
    pack, x, z0 = _v4_case(cuda_device, topology, n=200)
    kw = dict(rec_iters=5, rec_lr=LR, momentum=MOM)
    before = build.LAUNCHES[V4]
    one = fused_projection_v4(pack, x, z0, **kw)
    one_tile_before = build.LAUNCHES[ONE_TILE_COUNTER]
    chunked = fused_projection_v4(pack, x, z0, chunk=64, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES[V4] == before + 1 + 4     # 256 padded rows
    # 64-row chunks run the levels in the one-tile form
    assert build.LAUNCHES[ONE_TILE_COUNTER] == one_tile_before + 4
    assert one.shape == (200, 32) and torch.equal(one, chunked)
    rel = _row_rel(one, v4_loop_plain(pack, x, z0, **kw), z0)
    assert rel.median().item() <= TOL[5] and rel.max().item() <= 1e-1


@pytest.mark.cuda
def test_v4_kernel_rejects_bad_inputs(cuda_device):
    pack, x, z0 = _v4_case(cuda_device, "celeba_wide")
    kw = dict(rec_iters=1, rec_lr=LR, momentum=MOM)
    with pytest.raises(ValueError, match="multiple of 64"):
        fused_projection_v4(pack, x, z0, chunk=100, **kw)
    with pytest.raises(ValueError, match="out_dim"):
        fused_projection_v4(pack, x[:, :64], z0, **kw)
    with pytest.raises(ValueError, match="one device"):
        fused_projection_v4(pack, x.cpu(), z0, **kw)


def _published_v4(dev, name):
    """The 64x64 stack of configs/gans/<name>.yml at its published widths,
    bf16, seeded weights with the BatchNorm statistics of _v4_case."""
    import pathlib

    from defensegan_torch.configs import load_config
    cfg = load_config(str(pathlib.Path(__file__).resolve().parents[1]
                          / "defensegan_torch" / "configs" / "gans"
                          / f"{name}.yml"))
    tg = generator_for(cfg.type, cfg.gen_dim, torch.bfloat16, cfg.gen_arch,
                       cfg.latent_dim, gen=torch.Generator().manual_seed(0))
    tg.requires_grad_(False)
    gb = torch.Generator().manual_seed(1)
    for mod_name, mod in tg.named_modules():
        if mod_name.startswith("bn_"):
            mod.scale.copy_(1.0 + 0.3 * torch.randn(mod.scale.shape,
                                                    generator=gb))
            mod.bias.copy_(0.2 * torch.randn(mod.bias.shape, generator=gb))
            mod.mean.copy_(0.2 * torch.randn(mod.mean.shape, generator=gb))
            mod.var.copy_(0.5 + torch.rand(mod.var.shape, generator=gb))
    return cfg, tg.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["celeba", "celeba_wide", "imagenet64"])
def test_v4_state_built_once_equals_the_per_call_build(cuda_device, name):
    """make_v4_reconstructor builds the kernel's state (padded pack, grid
    tables, pointer and width tables) once and hands it to every
    fused_projection_v4 call; each call returns the z* that a call
    building its own state gives, bit for bit, one library call a
    chunk."""
    from defensegan_torch.defense.project import tile_restarts
    from defensegan_torch.kernels.fused_projection_v4 import \
        make_v4_reconstructor
    from defensegan_torch.models.generator import from_image_space
    cfg, tg = _published_v4(cuda_device, name)
    b, rr, k = 64, 2, cfg.latent_dim
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.rand(b, 64, 64, 3, generator=g, device=cuda_device)
    z0 = torch.randn(b, rr, k, generator=g, device=cuda_device)
    kw = dict(rec_iters=5, rec_lr=LR, momentum=MOM)
    run = make_v4_reconstructor(tg, (64, 64, 3), rec_rr=rr, **kw)
    before = build.LAUNCHES[V4]
    first, second = run(x, z0=z0), run(x, z0=z0)
    pack = pack_v4(tg)
    z_fin = fused_projection_v4(
        pack, tile_restarts(x_rows(pack, from_image_space(x)), rr),
        z0.reshape(b * rr, k), **kw).reshape(b, rr, k)
    torch.cuda.synchronize()
    assert build.LAUNCHES[V4] == before + 3
    pick = z_fin[torch.arange(b), first.all_losses.argmin(1)]
    assert torch.equal(first.z_star, pick)
    assert torch.equal(second.z_star, first.z_star)
    assert torch.equal(second.all_losses, first.all_losses)


@pytest.mark.cuda
def test_celeba_auto_pipeline_matches_the_reference_on_card(cuda_device):
    """celeba.yml at its published widths as the benchmark's `celeba`
    configuration states it (PROJECTION_KERNEL auto): every projection
    call runs v4, and DefendedPipeline.predict on 64 images meets each of
    the cell's limits against the float32 reference (benchmark/check.py),
    the detector calibrated on 128 images."""
    import time

    from benchmark import harness, spec
    from benchmark.system import ProgramSystem
    bench = spec.load_benchmark()
    conf = spec.config(bench, "celeba")
    conf = dict(conf, pipeline=dict(conf["pipeline"], calibration_images=128),
                check=dict(conf["check"], sample_images=64))
    traffic = dict(spec.traffic("bulk4k"), images_per_request=64,
                   pool_images=256, trace_requests=0)
    inputs = harness.Inputs(conf, traffic, 2 ** 31 + 21, cuda_device)
    before = build.LAUNCHES[V4]
    _, kept, recorder = harness.measure(
        inputs, lambda rec: ProgramSystem(conf, inputs.gen_w, inputs.clf_w,
                                          cuda_device, rec),
        0.0, False, time.perf_counter(), warm_up=False)
    assert dict(recorder.paths) == {"pallas_v4": 2}   # calibration, request
    assert build.LAUNCHES[V4] == before + 2
    correct, checked, _ = harness.judge_kept(inputs, kept, recorder.paths)
    assert correct, checked


# ---- the Hopper grid conv on its own (csrc/conv3x3_sm90.cuh through
# kernels/conv3x3.py), at the edges of its design
CONV_EDGES = {
    # mode, g, cin, cout, in_fine, out_fine, rows
    "g4_border_taps_interleaved_out": ("per_tap", 4, 512, 1024, 0, 256, 256),
    "g4_chain_rows_192": ("chain", 4, 128, 256, 0, 0, 192),
    "g7_chain": ("chain", 7, 128, 256, 0, 0, 128),
    "out_level_n64": ("tanh_grad", 16, 256, 64, 0, 0, 128),
    "run_192_out": ("per_tap", 8, 384, 768, 0, 192, 192),
    "run_192_in_backward": ("backward", 8, 768, 384, 192, 0, 128),
    "backward_one_slab_per_tap": ("backward", 16, 64, 256, 0, 0, 64),
    "backward_n64_cout_192": ("backward", 16, 384, 192, 0, 0, 192),
    "g7_backward_rows_192": ("backward", 7, 256, 128, 0, 0, 192),
    # the one-tile form (64-row tiles, the channels split between the
    # warpgroups; at the out level's n64 one warpgroup)
    "g7_chain_one_tile_rows_10": ("chain", 7, 128, 256, 0, 0, 10),
    "one_tile_per_tap_interleaved_out": ("per_tap", 8, 256, 512, 0, 128, 64),
    "out_level_n64_one_tile": ("tanh_grad", 16, 256, 64, 0, 0, 64),
}


def _conv_inputs(dev, mode, g, cin, cout, in_fine, m, seed):
    """Seeded inputs of one grid conv: (input in fine order where
    in_fine, weights, the mode's keywords)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=dev,
                                    generator=gen)).to(bf)
    blocked_in = rand(m, g * g * cin)
    w = rand(9 * cin, cout, scale=cin ** -0.5)
    kw = dict(bias=torch.randn(cout, device=dev, generator=gen))
    if mode == "tanh_grad":
        kw.update(x=torch.tanh(rand(m, g * g * cout).float()).to(bf),
                  scale=0.25)
    if mode == "backward":
        kw = dict(h=rand(m, g * g * cout))
    return to_fine(blocked_in, g, in_fine).contiguous(), w, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CONV_EDGES))
def test_conv3x3_kernel_matches_plain(cuda_device, case):
    """The kernel against its plain version on the same bf16 inputs,
    element by element, within the rounding band of
    conv3x3.rounding_excess: one bf16 ulp of the output, plus one ulp of
    every rounded tap in the backward. Rows past the last 128-row tile are
    not written; the backward leaves h as it was."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mode, g, cin, cout, in_fine, out_fine, m = CONV_EDGES[case]
    inp, w, kw = _conv_inputs(cuda_device, mode, g, cin, cout, in_fine, m,
                              seed=len(case))
    if mode == "backward":
        h_before = kw["h"].clone()
    before = build.LAUNCHES[COUNTER]
    got = conv3x3(inp, w, g, mode, in_fine=in_fine, out_fine=out_fine, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES[COUNTER] == before + 1
    ref = conv3x3_plain(inp, w, g, mode, in_fine=in_fine, out_fine=out_fine,
                        **kw)
    assert got.shape == ref.shape and torch.isfinite(got.float()).all()
    assert rounding_excess(got, ref, inp, w, g, mode, in_fine=in_fine,
                           out_fine=out_fine, scale=kw.get("scale", 1.0)) <= 0
    assert (got != 0).float().mean() > 0.2        # not an empty output
    if mode == "backward":
        assert torch.equal(kw["h"], h_before)       # the wrapper's copy


# ---- the one-tile form (csrc/conv3x3_sm90.cuh, conv3x3_sm90_one_tile) of
# a conv of at most 64 rows against the same rows inside a 256-row call
# (two 128-row tiles): every element sees the same wgmma sequence, so they
# are equal bit for bit, in every mode of kernels/conv3x3.py
ONE_TILE_WIDTHS = {
    # g, cin, cout, in_fine, out_fine
    "conv_a_forward": (7, 128, 256, 0, 0),
    "conv_a_backward": (7, 256, 128, 0, 0),
    "v4_level_interleaved_out": (8, 256, 512, 0, 128),
    "out_level_n64": (16, 256, 64, 0, 0),
}
# the tanh gradient and the backward write blocked order only
ONE_TILE_CASES = [(mode, widths) for mode in MODES
                  for widths, (*_, out_fine) in ONE_TILE_WIDTHS.items()
                  if not (out_fine and mode in ("tanh_grad", "backward"))]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [10, 64])
@pytest.mark.parametrize("mode, widths", ONE_TILE_CASES)
def test_conv3x3_one_tile_equals_the_128_row_form_bit_for_bit(
        cuda_device, mode, widths, rows):
    g, cin, cout, in_fine, out_fine = ONE_TILE_WIDTHS[widths]
    inp, w, kw = _conv_inputs(cuda_device, mode, g, cin, cout, in_fine, 256,
                              seed=len(widths) + rows)
    fine = dict(in_fine=in_fine, out_fine=out_fine)
    before = build.LAUNCHES[ONE_TILE_COUNTER]
    whole = conv3x3(inp, w, g, mode, **fine, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES[ONE_TILE_COUNTER] == before     # 128-row tiles
    part = {k: v[:rows].contiguous() if k in ("x", "h") else v
            for k, v in kw.items()}
    got = conv3x3(inp[:rows].contiguous(), w, g, mode, **fine, **part)
    torch.cuda.synchronize()
    assert build.LAUNCHES[ONE_TILE_COUNTER] == before + 1
    assert (got != 0).float().mean() > 0.2
    assert torch.equal(got, whole[:rows])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [10, 64, 65, 128])
def test_one_tile_count_names_the_kernel_the_card_runs(cuda_device, rows):
    """The one-tile form runs exactly where M <= 64, and ONE_TILE_COUNTER
    counts a call exactly where it ran: a conv's device trace names the
    one-tile kernel where the count moves. The profiler can drop a kernel
    record from a window, so a window without one is profiled again."""
    g, cin, cout, _, _ = ONE_TILE_WIDTHS["conv_a_forward"]
    inp, w, kw = _conv_inputs(cuda_device, "chain", g, cin, cout, 0, rows,
                              seed=rows)
    conv3x3(inp, w, g, "chain", **kw)               # build and warm up
    torch.cuda.synchronize()
    names = []
    for _ in range(3):
        before = build.LAUNCHES[ONE_TILE_COUNTER]
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            conv3x3(inp, w, g, "chain", **kw)
            torch.cuda.synchronize()
        counted = build.LAUNCHES[ONE_TILE_COUNTER] - before
        names = [e.name for e in prof.events() if "conv3x3_sm90" in e.name]
        if names:
            break
    assert len(names) == 1, names
    assert counted == (rows <= 64)
    assert ("conv3x3_sm90_one_tile" in names[0]) == (rows <= 64), names


# ---- the Hopper GEMM on its own (csrc/gemm_sm90.cuh through
# kernels/gemm.py), at the edges of its design: K 128 (two slabs), 160
# (conv B's, a half slab), 832 (v2i's 6.5 int8 slabs), 6272; N 128 (split
# K), 192 (conv B, a half tile), 832 (P, 6.5 tiles); M 192 (a half
# 128-row tile) and 10240 (the flagship's rows)
GEMM_EDGES = {
    # epilogue, M, K, N, operand type
    "fc_forward_k128": ("bias_relu", 192, 128, 6272, "bf16"),
    "fc_forward_amax_k128": ("bias_relu_amax", 192, 128, 6272, "bf16"),
    "h_at_d_n832": ("tanh_grad", 192, 6272, 832, "bf16"),
    "do_at_dt_k832": ("relu_mask", 192, 832, 6272, "bf16"),
    "fc_backward_split": ("momentum", 192, 6272, 128, "bf16"),
    "fc_backward_split_m10240": ("momentum", 10240, 6272, 128, "bf16"),
    "v4_fc_backward_k8192": ("momentum", 1024, 8192, 128, "bf16"),
    "conv_b_forward_n192": ("store", 192, 256, 192, "bf16"),
    "conv_b_backward_k160": ("relu_mask", 192, 160, 256, "bf16"),
    "store_m10240_n832": ("store", 10240, 6272, 832, "bf16"),
    "int8_h_at_dq": ("store", 192, 6272, 832, "int8"),
    "int8_do_at_dtq_k832": ("store", 192, 832, 6272, "int8"),
    "int8_m10240_k832": ("store", 10240, 832, 6272, "int8"),
    "int8_tanh_grad": ("tanh_grad_int8", 192, 6272, 832, "int8"),
    "int8_relu_mask_k832": ("relu_mask_int8", 192, 832, 6272, "int8"),
}


def gemm_case(dev, epilogue, m, k, n, kind, seed):
    """Seeded operands and epilogue inputs of one GEMM edge case; the
    int8 scales put the dequantized sums near 1."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=dev, generator=gen)
    bf = torch.bfloat16
    if kind == "int8":
        a = torch.randint(-127, 128, (m, k), device=dev, generator=gen,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (n, k), device=dev, generator=gen,
                          dtype=torch.int8)
    else:
        a, b = randn(m, k).to(bf), randn(k, n, scale=k ** -0.5).to(bf)
    kw = {}
    if epilogue in ("bias_relu", "bias_relu_amax", "tanh_grad",
                    "tanh_grad_int8"):
        kw["bias"] = randn(n)
    if epilogue in ("tanh_grad", "tanh_grad_int8"):
        kw.update(x=torch.tanh(randn(m, n)).to(bf), scale=2.0 / 784)
    if epilogue == "relu_mask":
        kw["h"] = randn(m, n).to(bf)
    if epilogue == "relu_mask_int8":
        kw["h"] = randn(m, n)
    if epilogue.endswith("int8"):
        kw.update(row_scale=torch.rand(m, device=dev, generator=gen) / 127.0,
                  col_scale=torch.rand(n, device=dev, generator=gen)
                  / (127.0 * k ** 0.5))
    if epilogue == "momentum":
        kw.update(z=randn(m, n), v=randn(m, n), lr=10.0, momentum=0.7)
    return a, b, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GEMM_EDGES))
def test_gemm_kernel_matches_plain(cuda_device, case):
    """The kernel against its plain version on the same inputs, element by
    element: int8 sums bit for bit, everything else within the band of
    gemm.rounding_excess; a row amax taken in the epilogue equals the
    amax of the kernel's own output exactly (a max has no order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    epilogue, m, k, n, kind = GEMM_EDGES[case]
    a, b, kw = gemm_case(cuda_device, epilogue, m, k, n, kind, len(case))
    z_before = kw["z"].clone() if "z" in kw else None
    before = build.LAUNCHES[GEMM_COUNTER]
    got = gemm(a, b, epilogue, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES[GEMM_COUNTER] == before + 1
    ref = gemm_plain(a, b, epilogue, **kw)
    if kind == "int8" and epilogue == "store":
        assert got.dtype == torch.int32 and torch.equal(got, ref)
        return
    outs = got if isinstance(got, tuple) else (got,)
    assert all(torch.isfinite(t.float()).all() for t in outs)
    assert gemm_excess(got, ref, a, b, epilogue, scale=kw.get("scale", 1.0),
                       lr=kw.get("lr", 0.0)) <= 0
    if epilogue in ("bias_relu_amax", "tanh_grad_int8"):
        assert torch.equal(got[1], got[0].abs().amax(1))
    if z_before is not None:
        assert torch.equal(kw["z"], z_before)           # the wrapper's copy
        assert split_k_for(k, n) > 1
    assert (outs[0] != 0).float().mean() > 0.2        # not an empty output


# v2's D products with their slab lists: (pack field, epilogue, a tile of
# D zeroed so that its list is empty)
SLAB_CASES = {"h@D": ("d", "tanh_grad", False),
              "h@D store": ("d", "store", False),
              "h@D empty tile": ("d", "store", True),
              "do@Dt": ("dt", "relu_mask", False),
              "do@Dt store": ("dt", "store", False)}


@pytest.mark.cuda
@pytest.mark.parametrize("m", [10, 64, 10240])
@pytest.mark.parametrize("case", list(SLAB_CASES))
def test_d_product_with_its_slab_list_equals_the_dense_walk(cuda_device,
                                                            case, m):
    """h @ D and do @ D^T of mnist_fast.yml's widths (seeded weights: the
    zero blocks are the deconv's) walking only their listed slabs, against
    the same product walking every slab (fp_gemm with no list), bit for
    bit: a block left out is all zero, so its products add exact zeros.
    A tile whose list is empty stores zero sums."""
    from defensegan_torch.kernels.gemm import slab_list
    name, epilogue, empty = SLAB_CASES[case]
    tg = generator_for("mnist", 16, torch.bfloat16, "wide", 128,
                       gen=torch.Generator().manual_seed(0))
    pack = pack_dense(tg.to(cuda_device))
    b = getattr(pack, name)
    if empty:
        b = b.clone()
        b[:, 256:384] = 0
    sl = slab_list(b) if empty else getattr(pack, f"{name}_slabs")
    assert sl.issued < sl.dense
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    a = torch.randn(m, b.shape[0], device=cuda_device, generator=gen)
    a = (torch.relu(a) if name == "d" else 0.01 * a).to(torch.bfloat16)
    kw = {}
    if epilogue == "tanh_grad":
        kw = dict(bias=pack.bd[0].contiguous(), scale=2.0 / 784,
                  x=torch.tanh(torch.randn(m, b.shape[1], device=cuda_device,
                                           generator=gen)).to(torch.bfloat16))
    if epilogue == "relu_mask":
        kw["h"] = torch.randn(m, b.shape[1], device=cuda_device,
                              generator=gen).to(torch.bfloat16)
    before = build.LAUNCHES[GEMM_COUNTER]
    listed = gemm(a, b, epilogue, slabs=sl, **kw)
    dense = gemm(a, b, epilogue, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES[GEMM_COUNTER] == before + 2
    bits = torch.int32 if epilogue == "store" else torch.int16
    assert torch.equal(listed.view(bits), dense.view(bits))
    assert (dense != 0).float().mean() > 0.2
    if empty:
        assert sl.off[3] == sl.off[2] and not listed[:, 256:384].any()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [10, 64, 10240])
def test_v2_zfinal_is_the_dense_walks_bit_for_bit(cuda_device, rows):
    """v2's z_final on the flagship at L 200 (scripts/torch_v2_zfinal.py)
    has the sha256 that the parent's dense walk of D gave on this card and
    torch build (its REFERENCE)."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "scripts"))
    import torch_v2_zfinal
    got = torch_v2_zfinal.zfinal(rows)
    assert got["same"] is not None, (
        f"no reference digest for {got['device']} / torch {got['torch']}: "
        "record one from the parent checkout (--root)", got)
    assert got["same"], got


@pytest.mark.cuda
def test_slab_counter_reads_the_lists_share_after_a_reconstruct(cuda_device):
    """After a flagship reconstruct the slab counter reads 182 of 686
    (26.5%) for h @ D and 142 of 637 (22.3%) for do @ D^T: per library
    call, M tiles x L x the list against every slab."""
    gan = _serving_gan("mnist_fast", cuda_device)
    build.SLABS.clear()
    x = torch.rand(3, 28, 28, 1, device=cuda_device)
    gan.reconstruct(x, gen=torch.Generator(device=cuda_device).manual_seed(0))
    torch.cuda.synchronize()
    assert gan.last_kernel == "pallas"
    s = build.SLABS
    # 3 images x R 10 = 30 rows: one 64-row call, one M tile, L 200
    assert (s["h@D.issued"], s["h@D.dense"]) == (200 * 182, 200 * 686)
    assert (s["do@Dt.issued"], s["do@Dt.dense"]) == (200 * 142, 200 * 637)


@pytest.mark.cuda
def test_training_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    """A run trained on the card restores on the card: the modules, both
    Adam states (their step counts stay on the host, as a fresh Adam keeps
    them) and the draw generator come back, and training goes on."""
    from defensegan_torch.configs import Config
    from defensegan_torch.gan import DefenseGAN

    cfg = Config(type="mnist", gen_arch="wide", gen_dim=4, disc_dim=4,
                 latent_dim=16, batch_size=8, disc_iters=2,
                 compute_dtype="float32", output_dir=str(tmp_path),
                 save_every=2, sample_every=0)
    data = np.random.RandomState(0).rand(32, 28, 28, 1).astype(np.float32)
    gan = DefenseGAN(cfg, device=cuda_device)
    gan.train(data, train_iters=2, quiet=True)
    back = DefenseGAN(cfg, device=cuda_device).restore()
    assert back.step == 2
    for a, b in ((gan.generator, back.generator), (gan.critic, back.critic)):
        for (k, x), (_, y) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
            assert torch.equal(x, y), k
    assert torch.equal(gan._train_gen.get_state(), back._train_gen.get_state())
    steps = [s["step"] for s in back.state.disc_opt.state.values()]
    assert all(t.device.type == "cpu" for t in steps)
    out = back.train(data, train_iters=3, quiet=True)
    assert back.step == 3 and np.isfinite(out["g_loss"])


# ---- the experiments' kernels (defensegan_torch/experiments/): the
# stream64 level at its published widths (the zero-block skip bit for bit
# against every block issued, and against v4's grid conv), the three v3
# variants at the narrow deep model's (their plain versions as tolerances
# as v3's; packed's fused conv B section bit for bit against v3's three
# launches, also at mnist.yml's widths)
@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1, 2])
def test_stream64_level_matches_plain(cuda_device, level):
    """dh equal to the plain version's but where the relu test of an h
    within float32 noise of 0 took the other side, dx within one bf16 ulp
    of every rounded tap of the plain backward of that dh
    (stream64_probe.check_against_plain)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = sp.LEVELS[level][0]
    a = sp.draw_arrays(level, 128, seed=level)
    pack = sp.level_tensors(*sp.pack_level(a["w"], a["b"], a["scale"],
                                           a["shift"]), g, cuda_device)
    x = torch.as_tensor(a["x0"]).to(cuda_device)
    cot = sp.to_phase_blocked(torch.as_tensor(a["cot"]).to(cuda_device)) \
        .to(torch.bfloat16)
    before = build.LAUNCHES[sp.COUNTER]
    dx, dh = sp.fused_level(x, cot, pack, return_dh=True)
    torch.cuda.synchronize()
    assert build.LAUNCHES[sp.COUNTER] == before + 1
    r = sp.check_against_plain(x, cot, pack, dx, dh)
    assert r["ok"], r


def _level(level, batch, device, seed=0, cot_ones=False):
    """A stream64 level's pack, x and phase-blocked bf16 cotangent."""
    g = sp.LEVELS[level][0]
    a = sp.draw_arrays(level, batch, seed=seed)
    pack = sp.level_tensors(*sp.pack_level(a["w"], a["b"], a["scale"],
                                           a["shift"]), g, device)
    x = torch.as_tensor(a["x0"]).to(device)
    cot = sp.to_phase_blocked(torch.as_tensor(a["cot"]).to(device))
    if cot_ones:
        cot = torch.ones_like(cot)
    return pack, x, cot.to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1, 2])
def test_stream64_skip_equals_every_block_bit_for_bit(cuda_device, level):
    """The zero blocks skipped (forward taps, backward K slabs; the walks
    heaviest first) against the kernel that issues every block: a skipped
    product was an exact zero, so dh and dx are equal bit for bit; 200
    images leave a part m-tile."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pack, x, cot = _level(level, 200, cuda_device, seed=level)
    before = build.LAUNCHES[sp.COUNTER]
    dx, dh = sp.fused_level(x, cot, pack, return_dh=True)
    dx0, dh0 = sp.fused_level(x, cot, pack, return_dh=True, skip=False)
    torch.cuda.synchronize()
    assert build.LAUNCHES[sp.COUNTER] == before + 2
    assert torch.equal(dh, dh0) and torch.equal(dx, dx0)
    assert (dx != 0).float().mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1, 2])
def test_v4_conv_equals_the_skipping_level_bit_for_bit(cuda_device, level):
    """v4's grid conv (kernels/conv3x3.py, no block skip) on the level's
    weights: its forward's relu decisions are the level's (cot = 1, so dh
    = [h > 0]) and its backward (h > 0 everywhere, the taps rounded) is
    the level's dx rounded to bf16, bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pack, x, cot = _level(level, 256, cuda_device, seed=10 + level,
                          cot_ones=True)
    g, n = pack.g, x.shape[0]
    dx, dh = sp.fused_level(x, cot, pack, return_dh=True)
    fwd = conv3x3(x.to(torch.bfloat16).reshape(n, -1), pack.w, g, "chain",
                  bias=pack.bias)
    ones = torch.ones((n, g * g * pack.ci), dtype=torch.bfloat16,
                      device=cuda_device)
    bwd = conv3x3(dh.reshape(n, -1), pack.wt, g, "backward", h=ones)
    torch.cuda.synchronize()
    assert torch.equal(fwd > 0, dh.reshape(n, -1) > 0)
    assert torch.equal(bwd, dx.reshape(n, -1).to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("gen_dim, n", [(4, 200), (64, 200), (64, 333)])
def test_packed_fused_section_equals_three_launches_bit_for_bit(
        cuda_device, gen_dim, n):
    """The packed loop with conv B's section as one kernel against the
    same loop with v3's three launches (fp_v3_packed_launches_run): the
    same roundings and orders, so z_final is equal bit for bit; ca 64 and
    256 (gen_dim 4, 64), rows that leave the persistent grid a part wave
    (200 and 333 latents, padded to 256 and 384, on 132 blocks of two
    warpgroups)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tg = generator_for("mnist", gen_dim, torch.bfloat16, "deep", 128,
                       gen=torch.Generator().manual_seed(gen_dim))
    tg = tg.to(cuda_device).requires_grad_(False)
    rng = np.random.RandomState(n)
    x = torch.from_numpy(np.tanh(rng.randn(n, 784)).astype(np.float32)) \
        .to(cuda_device)
    z0 = torch.from_numpy(rng.randn(n, 128).astype(np.float32)) \
        .to(cuda_device)
    pack = pack_s2d(tg)
    kw = dict(rec_iters=5, rec_lr=LR, momentum=MOM)
    before = build.LAUNCHES[VARIANTS["packed"].counter]
    fused = run_packed(pack, x, z0, **kw)
    three = run_packed(pack, x, z0, fused=False, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES[VARIANTS["packed"].counter] == before + 2
    assert (fused - z0).abs().max().item() > 1e-3
    assert torch.equal(fused, three)


@pytest.mark.cuda
@pytest.mark.parametrize("n, steps, chunk", [
    (10, 5, None), (200, 5, None), (333, 5, 192), (1024, 5, None),
    (1024, 200, None)])
def test_v3_fused_section_equals_three_launches_bit_for_bit(
        cuda_device, n, steps, chunk):
    """v3 on mnist's deep generator (c0 128, ca 256, cb 16, g 7) takes the
    fused conv B section by its shapes (fp_v3_fused_run) and gives the
    three-launch entry's z_final (fp_v3_run) bit for bit: 10 rows (one
    64-row tile, a latent a block), 200 and 333 (part waves of the
    persistent grid; 333 in 192-row chunks), 1024 at L 5 and 200. Each
    entry's counter rises by the calls, one a chunk."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tg = generator_for("mnist", 64, torch.bfloat16, "deep", 128,
                       gen=torch.Generator().manual_seed(n))
    tg = tg.to(cuda_device).requires_grad_(False)
    rng = np.random.RandomState(n)
    x = torch.from_numpy(np.tanh(rng.randn(n, 784)).astype(np.float32)) \
        .to(cuda_device)
    z0 = torch.from_numpy(rng.randn(n, 128).astype(np.float32)) \
        .to(cuda_device)
    pack = pack_s2d(tg)
    fused_state, three_state = s2d_state(pack), s2d_state(pack, entry=ENTRY)
    assert (fused_state.entry, fused_state.counter) == (FUSED_ENTRY,
                                                        FUSED_COUNTER)
    rows = -(-n // 64) * 64
    calls = -(-rows // (chunk or rows))
    kw = dict(rec_iters=steps, rec_lr=LR, momentum=MOM, chunk=chunk)
    before = build.LAUNCHES.copy()
    fused = fused_projection_s2d(pack, x, z0, state=fused_state, **kw)
    three = fused_projection_s2d(pack, x, z0, state=three_state, **kw)
    torch.cuda.synchronize()
    for key in (FUSED_COUNTER, three_state.library):
        assert build.LAUNCHES[key] == before[key] + calls, key
    assert (fused - z0).abs().max().item() > 1e-3
    assert torch.equal(fused, three)


# deep generators whose conv B section the fused kernel cannot take, so
# that v3 runs its three-launch entry: a 3-channel output (cb 48) and
# channels[1] 128 (ca 512)
THREE_LAUNCH_GENERATORS = {"rgb": ((8, 4), 3), "wide_ca": ((8, 128), 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("name", sorted(THREE_LAUNCH_GENERATORS))
def test_three_launch_v3_matches_plain_where_it_runs(cuda_device, name,
                                                     steps):
    """Where the shapes leave v3 its three-launch entry (fp_v3_run), that
    entry matches the plain version as test_kernel_matches_plain holds v3
    on the deep MNIST generator, and counts under v3's library key."""
    torch.backends.cuda.matmul.allow_tf32 = False
    channels, out = THREE_LAUNCH_GENERATORS[name]
    tg = Generator(latent_dim=32, base_hw=7, channels=channels,
                   out_channels=out, dtype=torch.bfloat16,
                   gen=torch.Generator().manual_seed(0))
    tg = tg.to(cuda_device).requires_grad_(False)
    pack = pack_s2d(tg)
    state = s2d_state(pack)
    assert (state.entry, state.counter) == (ENTRY, None)
    rng = np.random.RandomState(0)
    width = pack.grid_hw ** 2 * pack.cb
    x = torch.from_numpy(np.tanh(rng.randn(128, width)).astype(np.float32))
    z0 = torch.from_numpy(rng.randn(128, 32).astype(np.float32))
    x, z0 = x.to(cuda_device), z0.to(cuda_device)
    kw = dict(rec_iters=steps, rec_lr=LR, momentum=MOM)
    before = build.LAUNCHES.copy()
    got = fused_projection_s2d(pack, x, z0, state=state, chunk=64, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["fused_projection_v3"] == \
        before["fused_projection_v3"] + 2          # two 64-row chunks
    assert build.LAUNCHES[FUSED_COUNTER] == before[FUSED_COUNTER]
    ref = s2d_loop_plain(pack, x, z0, **kw)
    moved = (ref - z0).abs().max().item()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= TOL[steps] * moved


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_v3_variant_matches_plain(cuda_device, variant, steps):
    torch.backends.cuda.matmul.allow_tf32 = False
    tg, x, z0 = _case(cuda_device, arch="deep")
    pack, var = pack_s2d(tg), VARIANTS[variant]
    before = build.LAUNCHES[var.counter]
    got = var.loop(pack, x, z0, rec_iters=steps, rec_lr=LR, momentum=MOM,
                   chunk=64)
    torch.cuda.synchronize()
    assert build.LAUNCHES[var.counter] == before + 2    # two 64-row chunks
    ref = var.plain(pack, x, z0, rec_iters=steps, rec_lr=LR, momentum=MOM)
    moved = (ref - z0).abs().max().item()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= TOL[steps] * moved


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 200, 320])
def test_v3_ilp_equals_v3_bit_for_bit(cuda_device, n):
    """One chain (64 rows), two equal halves (200 rows padded to 256) and
    two unequal ones (320: 192 + 128): every row is v3's."""
    tg, x, z0 = _case(cuda_device, n=n, arch="deep")
    pack = pack_s2d(tg)
    kw = dict(rec_iters=5, rec_lr=LR, momentum=MOM)
    got = fused_projection_ilp(pack, x, z0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, fused_projection_s2d(pack, x, z0, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [200, 328])
@pytest.mark.parametrize("mode", ["chain", "backward"])
def test_conv_a_pingpong_equals_coop_bit_for_bit(cuda_device, mode, rows):
    """ilp's ping-pong schedule computes v3's conv A bit for bit, forward
    (one chain) and backward (each tap rounded), at conv A's widths (c0
    128, ca 256): ragged M (200 rows), and tile counts that the grid does
    not divide (328 rows: 294 and 147 tiles on 132 SMs); both within the
    rounding band of the plain conv."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    g, c0, ca = 7, 128, 256
    cin, cout = (c0, ca) if mode == "chain" else (ca, c0)

    def draw(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=cuda_device,
                                    generator=gen)).to(torch.bfloat16)
    inp = torch.relu(draw(rows, g * g * cin)) if mode == "chain" \
        else draw(rows, g * g * cin)
    w = draw(9 * cin, cout, scale=0.05)
    kw = dict(bias=torch.randn(cout, device=cuda_device, generator=gen)) \
        if mode == "chain" else dict(h=draw(rows, g * g * cout))
    before = build.LAUNCHES[CONV_COUNTER]
    coop = conv_a(inp, w, g, mode, schedule="coop", **kw)
    ping = conv_a(inp, w, g, mode, schedule="pingpong", **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES[CONV_COUNTER] == before + 2
    assert torch.equal(coop, ping)
    ref = conv3x3_plain(inp, w, g, mode, **kw)
    assert rounding_excess(ping, ref, inp, w, g, mode) <= 0.0


@pytest.mark.cuda
def test_conv_a_chained_backward_matches_plain(cuda_device):
    """conv A's backward with its taps in one chain (packed's, the
    ceilings' no-fold launch), both schedules bit for bit, within one bf16
    ulp of the output plus 1e-4 of the summed absolute products of the
    plain float32 sum, rounded once."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    g, cin, cout, rows = 7, 256, 128, 200

    def draw(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=cuda_device,
                                    generator=gen)).to(torch.bfloat16)
    inp, w = draw(rows, g * g * cin), draw(9 * cin, cout, scale=0.05)
    h = draw(rows, g * g * cout)
    coop = conv_a(inp, w, g, "backward_chain", h=h, schedule="coop")
    ping = conv_a(inp, w, g, "backward_chain", h=h, schedule="pingpong")
    torch.cuda.synchronize()
    assert torch.equal(coop, ping)
    ref = conv_a(inp.cpu(), w.cpu(), g, "backward_chain", h=h.cpu())
    mag = conv_a(inp.abs().cpu(), w.abs().cpu(), g, "backward_chain",
                 h=torch.ones_like(h.cpu())).float()
    err = (coop.cpu().float() - ref.float()).abs()
    assert (err <= 2.0 ** -7 * ref.float().abs() + 1e-4 * mag).all()


@pytest.mark.cuda
def test_v3p_keeps_h1s_pad_column_at_zero(cuda_device):
    """fp_v3p_run on scratch filled with ones: z_final equals the
    wrapper's bit for bit, and h1's pad column is zero after the call
    (zeroed once, never written: conv A walks the real pixels only)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tg, x, z0 = _case(cuda_device, n=128, arch="deep")
    pack = pack_s2d(tg)
    kw = dict(rec_iters=3, rec_lr=LR, momentum=MOM)
    ref = v3p.fused_projection_s2d_padded(pack, x, z0, **kw)
    state = v3p.v3p_state(pack)
    x_pad = v3p.pad_pixels(x.to(torch.bfloat16), pack.grid_hw, pack.cb)
    weights, scratch, dims = list(state.weights), state.scratch, state.dims
    m, kp = x_pad.shape[0], dims[0]
    z = torch.zeros((m, kp), dtype=torch.float32, device=cuda_device)
    z[:, :z0.shape[1]] = z0
    v = torch.zeros_like(z)
    bufs = [torch.ones((m, c), dtype=dt, device=cuda_device)
            for c, dt in scratch]
    ptrs = [t.data_ptr() for t in weights + bufs]
    lib = build.load(v3p.LIBRARY)
    fn = lib.fp_v3p_run
    fn.argtypes = [ctypes.c_void_p] * (3 + len(ptrs)) + \
        [ctypes.c_int] * (2 + len(dims)) + [ctypes.c_float] * 3 + \
        [ctypes.c_void_p]
    rc = fn(z.data_ptr(), v.data_ptr(), x_pad.data_ptr(), *ptrs, m, *dims,
            kw["rec_iters"], LR, MOM, 2.0 / x.shape[1],
            torch.cuda.current_stream(cuda_device).cuda_stream)
    torch.cuda.synchronize()
    build.check(lib, rc, "fp_v3p_run")
    assert torch.equal(z[:, :z0.shape[1]], ref)
    g = pack.grid_hw
    h1 = bufs[2].reshape(m, g, g + 1, -1)
    assert torch.equal(h1[:, :, g], torch.zeros_like(h1[:, :, g]))
    assert (h1[:, :, :g] != 0).any()


# ---- the two compile probes (defensegan_torch/experiments/v3_diag.py,
# v3_diag2.py): the ten cases at the script's shapes, the seven cuts at the
# narrow deep model's widths (padded to the kernel's tiles and cropped)
@pytest.mark.cuda
@pytest.mark.parametrize("name", list(v3_diag.CASES))
def test_v3_diag_case_matches_plain(cuda_device, name):
    """Within the case's bound (v3_diag.check: copies bit for bit, products
    within gemm.rounding_excess, k6 within 8 float32 ulps of its terms,
    the chains within 1e-2 of the largest magnitude)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = v3_diag.draw_inputs(name, cuda_device)
    before = build.LAUNCHES[v3_diag.COUNTER]
    got = v3_diag.diag_case(name, *inputs)
    torch.cuda.synchronize()
    assert build.LAUNCHES[v3_diag.COUNTER] == before + 1
    r = v3_diag.check(name, got, v3_diag.diag_case_plain(name, *inputs),
                      inputs)
    assert r["ok"], r


@pytest.mark.cuda
def test_v3_diag2_cuts_match_plain(cuda_device):
    """Each section within one bf16 ulp plus 1e-3 of its largest magnitude
    of the plain version's from the kernel's earlier sections, z_out equal
    to z0 before `full`, `full` within TOL[1] of the step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tg, x, z0 = _case(cuda_device, n=100, arch="deep")
    pack = pack_s2d(tg)
    sections = {}
    for upto in CUTS:
        before = build.LAUNCHES[v3_diag2.COUNTER]
        z_out, sections[upto] = v3_diag2.run_cut(pack, x, z0, upto)
        torch.cuda.synchronize()
        assert build.LAUNCHES[v3_diag2.COUNTER] == before + 1
        if upto != "full":
            assert torch.equal(z_out, z0), upto
    res = v3_diag2.check_sections(pack, x, z0, sections)
    assert all(r["ok"] for r in res.values()), res
    ref, _ = v3_diag2.cut_plain(pack, x, z0, "full")
    moved = (ref - z0).abs().max().item()
    assert (z_out - ref).abs().max().item() <= TOL[1] * moved


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100, 64])
def test_v3_diag2_plan_reused_equals_fresh_calls(cuda_device, n):
    """One plan run through all seven cuts twice (and on NaN targets)
    equals a fresh run_cut on the pack bit for bit: the plan replays the
    cut's CUDA graph, the pack issues the same launches one by one; one
    launch counted a run."""
    tg, x, z0 = _case(cuda_device, n=n, arch="deep")
    pack = pack_s2d(tg)
    plan = v3_diag2.prepare(pack, n, cuda_device)
    xn = x.clone()
    xn[n // 2, 7] = float("nan")
    for targets in (x, x, xn):
        for upto in CUTS:
            ref = [t.clone() for t in v3_diag2.run_cut(pack, targets, z0,
                                                       upto)]
            before = build.LAUNCHES[v3_diag2.COUNTER]
            got = v3_diag2.run_cut(plan, targets, z0, upto)
            torch.cuda.synchronize()
            assert build.LAUNCHES[v3_diag2.COUNTER] == before + 1
            for a, b in zip(got, ref):
                assert torch.equal(torch.isnan(a), torch.isnan(b))
                assert torch.equal(a.nan_to_num(), b.nan_to_num()), upto


@pytest.mark.cuda
def test_v3_diag2_plan_refuses_mismatch_on_card(cuda_device):
    tg, x, z0 = _case(cuda_device, n=64, arch="deep")
    pack = pack_s2d(tg)
    plan = v3_diag2.prepare(pack, 64, cuda_device)
    with pytest.raises(ValueError, match="latents"):
        v3_diag2.run_cut(plan, x[:32], z0[:32], "full")
    with pytest.raises(ValueError, match="one device"):
        v3_diag2.run_cut(plan, x.cpu(), z0.cpu(), "full")
    # inputs shaped for another pack: z0 of another k, x of another width
    with pytest.raises(ValueError, match=r"\[n, k\]"):
        v3_diag2.run_cut(plan, x, z0[:, :-1], "full")
    with pytest.raises(ValueError, match="out_dim"):
        v3_diag2.run_cut(plan, x[:, :-pack.cb], z0, "full")


@pytest.mark.cuda
def test_v3_diag_launch_floor_is_measured(cuda_device):
    """launch_costs: every figure a positive number of microseconds, the
    bare ctypes call cheaper than a ctypes call that launches."""
    r = v3_diag.launch_costs(cuda_device, calls=50)
    assert all(v > 0 for v in r.values()), r
    assert r["bare_ctypes_host_us"] < r["empty_kernel_host_us"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mask-lane-slice", "fori-shift-matmul"])
def test_v3_diag_outputs_stay_distinct_across_slabs(cuda_device, name):
    """Every call allocates its own output: each of 35 calls on other
    inputs, kept, then a call on another stream, still holds its own
    result (copies bit for bit, the chain within its bound) and no two
    share memory."""
    torch.backends.cuda.matmul.allow_tf32 = False
    base = v3_diag.draw_inputs(name, cuda_device)
    runs = []
    for i in range(35):
        inputs = [base[0] * (1.0 + 0.125 * i)] + base[1:]
        runs.append((inputs, v3_diag.diag_case(name, *inputs)))
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        inputs = [base[0] * -1.0] + base[1:]
        runs.append((inputs, v3_diag.diag_case(name, *inputs)))
    torch.cuda.synchronize()
    ptrs = {out.data_ptr() for _, out in runs}
    assert len(ptrs) == len(runs)
    for inputs, out in runs:
        r = v3_diag.check(name, out, v3_diag.diag_case_plain(name, *inputs),
                          inputs)
        assert r["ok"], r


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(v3_diag.CASES))
def test_v3_diag_into_a_given_output_equals_the_allocating_call(cuda_device,
                                                                 name):
    """diag_case_into writes the kernel's result into the given output,
    bit for bit what diag_case returns, and the PyTorch composition into
    that output equals its allocating form; one launch counted a call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = v3_diag.draw_inputs(name, cuda_device)
    ref = v3_diag.diag_case(name, *inputs)
    out = torch.full_like(ref, float("nan"))
    before = build.LAUNCHES[v3_diag.COUNTER]
    got = v3_diag.diag_case_into(out, name, *inputs)
    torch.cuda.synchronize()
    assert build.LAUNCHES[v3_diag.COUNTER] == before + 1
    assert got is out and torch.equal(out, ref)
    lib = v3_diag.diag_case_library(name, *inputs)
    assert torch.equal(v3_diag.diag_case_library(name, *inputs, out=out), lib)


@pytest.mark.cuda
def test_int8_accuracy_gate_rows_on_card(cuda_device):
    """The accuracy gate's rows (cli/int8_accuracy_gate.py::kernel_rows) on
    the committed flagship at 256 test images: pallas runs v2 and
    pallas_int8 v2i, and both stay within 2 of 256 images of xla's clean-
    and FGSM(0.1)-defended accuracy on the same draws (chip_smoke.py
    phase 12a's bound). Classifier A is trained one epoch (seed 5) on the
    stand-in data, so the accuracies are a path check; clean-defended
    must reach 0.9 all the same. It runs in the tool's exact_numerics(),
    as main() does."""
    import pathlib

    from defensegan_torch.attacks.fgsm import fgsm
    from defensegan_torch.cli import int8_accuracy_gate as gate
    from defensegan_torch.configs import load_config
    from defensegan_torch.data import get_dataset
    from defensegan_torch.eval.classifier import train_classifier
    from defensegan_torch.gan import DefenseGAN
    from defensegan_torch.models import build_classifier

    run = str(pathlib.Path(__file__).resolve().parents[1] / "output"
              / "gans" / "mnist_fast")
    gan = DefenseGAN(load_config(run).replace(output_dir=run),
                     device=cuda_device).load()
    ds = get_dataset("mnist")
    x_tr, y_tr = ds.load("train")
    x_te, y_te = (a[:256] for a in ds.load("test"))
    before = dict(build.LAUNCHES)
    with gate.exact_numerics():
        clf = train_classifier(build_classifier(
            "A", gen=torch.Generator().manual_seed(5)).to(cuda_device),
            x_tr, y_tr, seed=5, epochs=1)
        adv = fgsm(clf.logits_fn(), torch.as_tensor(x_te, device=cuda_device),
                   torch.as_tensor(y_te, device=cuda_device),
                   0.1).cpu().numpy()
        rows = {r["kernel"]: r for r in gate.kernel_rows(
            gan, clf.logits_fn(), x_te, y_te, adv)}
    assert {k: r["path"] for k, r in rows.items()} == {
        "xla": "xla", "pallas": "pallas", "pallas_int8": "pallas_int8"}
    for name in ("fused_projection_v2", "fused_projection_v2i"):
        assert build.LAUNCHES[name] > before[name]
    for kernel in ("pallas", "pallas_int8"):
        for metric in ("clean_defended", "fgsm01_defended"):
            assert abs(rows[kernel][metric] - rows["xla"][metric]) \
                <= 2 / 256, (kernel, metric, rows)
    assert rows["xla"]["clean_defended"] >= 0.9


def _serving_gan(config, device):
    """The benchmark's two configurations: the committed flagship (v2) and
    the deep mnist.yml generator, seeded (v3); R 10, L 200, bf16."""
    import pathlib

    from defensegan_torch.configs import load_config
    from defensegan_torch.gan import DefenseGAN

    root = pathlib.Path(__file__).resolve().parents[1]
    over = dict(COMPUTE_DTYPE="bfloat16", PROJECTION_KERNEL="auto",
                REC_INIT="random", REC_RR=10, REC_ITERS=200, REC_LR=10.0,
                REC_MOMENTUM=0.7)
    if config == "mnist_fast":
        run = str(root / "output" / "gans" / "mnist_fast")
        return DefenseGAN(load_config(run, over).replace(output_dir=run),
                          device=device).load()
    cfg = load_config(str(root / "defensegan_torch" / "configs" / "gans"
                          / "mnist.yml"), over)
    return DefenseGAN(cfg, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("config, kernel", [
    ("mnist_fast", "fused_projection_v2"), ("mnist", "fused_projection_v3")])
def test_one_image_predict_equals_it_inside_a_256_batch_on_card(
        cuda_device, config, kernel):
    """A one-image DefendedPipeline.predict (10 rows, which the kernel
    wrapper pads to its 64-row tile) against the same image inside an
    explicit batch_size=256 call (2560 rows), with the same draws. A row's
    loop does not depend on the other rows (test_kernel_pads_rows_and_
    chunks_exactly), so z* is equal bit for bit; the selection's losses and
    G(z*) run bf16 products at another row count, so the restarts' final
    losses agree within TOL[1] relative and x_hat (in [0, 1]) within TOL[1],
    one bf16 rounding; prediction and flag exactly."""
    from defensegan_torch.defense.pipeline import DefendedPipeline
    from defensegan_torch.eval.accuracy import batched_reconstruct
    from defensegan_torch.models import build_classifier

    gan = _serving_gan(config, cuda_device)
    # mnist's deep generator takes v3's fused conv B entry, counted under
    # its own key
    key = FUSED_COUNTER if kernel == "fused_projection_v3" else kernel
    clf = build_classifier("A", gen=torch.Generator().manual_seed(5))
    pipe = DefendedPipeline(gan, clf.to(cuda_device).requires_grad_(False),
                            fpr=0.5)
    g = torch.Generator(device=cuda_device).manual_seed(11)
    k = gan.cfg.latent_dim
    table = torch.randn(264, 10, k, generator=g, device=cuda_device)
    calib = torch.randn(256, 10, k, generator=g, device=cuda_device)
    rng = np.random.RandomState(0)
    pipe.calibrate(rng.rand(256, 28, 28, 1).astype(np.float32),
                   batch_size=256, z0_fn=lambda p, lo: calib[lo:])
    x = rng.rand(200, 28, 28, 1).astype(np.float32)
    full = pipe.predict(x, batch_size=256, z0_fn=lambda p, lo: table[lo:])
    (big, _, _), = batched_reconstruct(gan, x, batch_size=256,
                                       z0_fn=lambda lo: table[lo:])
    before = build.LAUNCHES[key]
    for j in (0, 77, 199):
        one = pipe.predict(x[j:j + 1], z0_fn=lambda p, lo: table[j + lo:])
        assert one.pred[0] == full.pred[j] and \
            one.flagged[0] == full.flagged[j], j
        (res, _, _), = batched_reconstruct(gan, x[j:j + 1],
                                           z0_fn=lambda lo: table[j + lo:])
        assert res.z_star.shape[0] == 1 and gan.last_kernel == "pallas"
        assert torch.equal(res.z_star[0], big.z_star[j]), j
        rel = ((res.all_losses[0] - big.all_losses[j]).abs()
               / big.all_losses[j].abs()).max().item()
        assert rel <= TOL[1], (j, rel)
        err = (res.x_hat[0] - big.x_hat[j]).abs().max().item()
        assert err <= TOL[1], (j, err)
    assert build.LAUNCHES[key] == before + 6
    assert full.flagged.any() and not full.flagged.all()


def _bench_args(*extra):
    import pathlib
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import bench_torch
    return bench_torch.build_parser().parse_args(list(extra))


@pytest.mark.cuda
def test_bench_worker_labels_what_ran_on_card(cuda_device, tmp_path, capsys):
    """bench_torch.py's worker at batch 64, R 2, L 5 on the committed
    flagship: the ladder's records name the loop that ran (xla, then
    pallas), the last headline is pallas_int8 when the committed card
    stamp passes (else pallas), and the deep leg is a pallas (v3) leg;
    each leg's library launched."""
    import json
    import pathlib

    from defensegan_torch.cli.bench import (int8_gate_stamp, leg_launches,
                                            run_worker)
    from defensegan_torch.configs import load_config, save_config

    run = str(pathlib.Path(__file__).resolve().parents[1] / "output"
              / "gans" / "mnist_fast")
    save_config(load_config(run).replace(output_dir=run), str(tmp_path))
    want = "pallas_int8" if int8_gate_stamp(run) is not None else "pallas"
    args = _bench_args("--cfg", str(tmp_path), "--batch", "64",
                       "--deep_batch", "64", "--rec_rr", "2",
                       "--rec_iters", "5", "--repeats", "1", "--deadline",
                       "0")
    assert run_worker(args) == 0
    out, err = capsys.readouterr()
    recs = [json.loads(ln) for ln in out.splitlines() if ln.strip()]
    launches = leg_launches(err)
    assert [r["kernel"] for r in recs[:2]] == ["xla", "pallas"]
    assert all(r.get("partial") for r in recs[:-1])
    assert "partial" not in recs[-1]
    assert recs[-1]["kernel"] == want
    assert recs[-1]["deep_kernel"] == "pallas"
    assert recs[-1]["device"]["type"] == "cuda"
    assert recs[-1]["value"] > 0 and recs[-1]["deep_value"] > 0
    assert launches["headline_xla"] == {}
    assert launches["headline_pallas"]["fused_projection_v2"] > 0
    assert launches["deep_pallas"].get(FUSED_COUNTER, 0) > 0
    if want == "pallas_int8":
        assert launches["headline_int8"]["fused_projection_v2i"] > 0


@pytest.mark.cuda
def test_bench_deep_int8_request_never_labelled_int8(cuda_device):
    """A pallas_int8 request on the deep generator runs the bf16 v3: with
    fallback_to_auto the leg is measured and labelled pallas, without it
    the leg refuses ("not runnable")."""
    import os

    from defensegan_torch.cli.bench import CFG_DIR, measure

    deep = os.path.join(CFG_DIR, "mnist.yml")
    before = build.LAUNCHES[FUSED_COUNTER]
    v, k, _ = measure(deep, 64, 2, 5, 1, "pallas_int8",
                      fallback_to_auto=True, device=cuda_device)
    assert v > 0 and k == "pallas"
    assert build.LAUNCHES[FUSED_COUNTER] > before
    with pytest.raises(RuntimeError, match="not runnable"):
        measure(deep, 64, 2, 5, 1, "pallas_int8", device=cuda_device)
