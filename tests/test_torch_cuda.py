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
narrow deep model's, the ten construct probes at their script's shapes and
the cut steps at the narrow deep model's widths.
Tolerances are chip_smoke.py's elementwise bounds: kernel and plain
version differ only in float32 summation order, which flips a bf16
rounding (2^-8 relative) of an intermediate now and then, carried forward
by the lr = 10 momentum steps.
"""

import numpy as np
import pytest
import torch

from defensegan_torch.experiments import stream64_probe as sp
from defensegan_torch.experiments import v3_diag, v3_diag2
from defensegan_torch.experiments.v3_ilp import fused_projection_ilp
from defensegan_torch.experiments.v3_variants import VARIANTS
from defensegan_torch.kernels import build
from defensegan_torch.kernels.conv3x3 import (COUNTER, conv3x3, conv3x3_plain,
                                              rounding_excess, to_fine)
from defensegan_torch.kernels.fused_projection_v2 import (
    dense_loop_plain, fused_projection_dense, pack_dense, pad_targets)
from defensegan_torch.kernels.fused_projection_v2i import (
    dense_int8_loop_plain, fused_projection_dense_int8, pack_dense_int8)
from defensegan_torch.kernels.fused_projection_v3 import (
    CUTS, fused_projection_s2d, pack_s2d, s2d_loop_plain)
from defensegan_torch.kernels.fused_projection_v4 import (
    fused_projection_v4, pack_v4, v4_loop_plain, x_rows)
from defensegan_torch.kernels.gemm import COUNTER as GEMM_COUNTER
from defensegan_torch.kernels.gemm import gemm, gemm_plain, split_k_for
from defensegan_torch.kernels.gemm import rounding_excess as gemm_excess
from defensegan_torch.models.generator import generator_for

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


def _kernel(name, tg):
    """(pack, wrapper, plain version, bf16 base pack) of a kernel."""
    if name == "fused_projection_v3":
        return pack_s2d(tg), fused_projection_s2d, s2d_loop_plain, None
    if name == "fused_projection_v2":
        pack = pack_dense(tg)
        return pack, fused_projection_dense, dense_loop_plain, pack
    pack = pack_dense_int8(tg)
    return (pack, fused_projection_dense_int8, dense_int8_loop_plain,
            pack.base)


KERNELS = ["fused_projection_v2", "fused_projection_v2i",
           "fused_projection_v3"]


def _arch(name):
    return "deep" if name == "fused_projection_v3" else "wide"


def _targets(base, x):
    """The plain version's x: v2 / v2i pad it to P; v3 takes it as is."""
    return x if base is None else pad_targets(base, x, x.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("name", KERNELS)
def test_kernel_matches_plain(cuda_device, name, steps):
    tg, x, z0 = _case(cuda_device, arch=_arch(name))
    pack, run, plain, base = _kernel(name, tg)
    before = build.LAUNCHES[name]
    got = run(pack, x, z0, rec_iters=steps, rec_lr=LR, momentum=MOM,
              chunk=64)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 2     # two 64-row chunks
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
    pack, run, plain, base = _kernel(name, tg)
    kw = dict(rec_iters=5, rec_lr=LR, momentum=MOM)
    before = build.LAUNCHES[name]
    one = run(pack, x, z0, **kw)
    chunked = run(pack, x, z0, chunk=64, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 1 + 4   # 256 padded rows
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
    chunked = fused_projection_v4(pack, x, z0, chunk=64, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES[V4] == before + 1 + 4     # 256 padded rows
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
}


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
    gen = torch.Generator(device=cuda_device).manual_seed(len(case))
    bf = torch.bfloat16

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=cuda_device,
                                    generator=gen)).to(bf)
    blocked_in = rand(m, g * g * cin)
    w = rand(9 * cin, cout, scale=cin ** -0.5)
    kw = dict(bias=torch.randn(cout, device=cuda_device, generator=gen))
    if mode == "tanh_grad":
        kw.update(x=torch.tanh(rand(m, g * g * cout).float()).to(bf),
                  scale=0.25)
    if mode == "backward":
        kw = dict(h=rand(m, g * g * cout))
        h_before = kw["h"].clone()
    inp = to_fine(blocked_in, g, in_fine).contiguous()
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
# stream64 level at its published widths, the three v3 variants at the
# narrow deep model's (their plain versions as tolerances as v3's)
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
