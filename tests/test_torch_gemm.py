"""The GEMM under every product of the fused loops (defensegan_torch/
kernels/gemm.py; the kernel is csrc/gemm_sm90.cuh), on the CPU.

The kernel itself runs only on the card (tests/test_torch_cuda.py -k gemm,
chip_smoke.py phase 3a'''), against `gemm_plain`. Here:

  - the int8 pack's K-major copies (8-bit wgmma reads B only K-major) are
    the JAX package's dq / dtq transposed, value for value;
  - the four products chained through `gemm_plain` and its epilogues ARE
    the plain loops (dense_loop_plain, dense_int8_loop_plain), bit for bit
    at L 1-3: so holding each product against gemm_plain on the card holds
    the loop's arithmetic, and the plain loops are held against the Pallas
    kernels in interpret mode by test_torch_fused_v2.py / _v2i.py;
  - the split-K rule depends on K and N only, and cuts every K of the
    loops into non-empty whole-slab ranges;
  - the rounding band of `rounding_excess` holds a split sum and catches a
    dropped slab or a misplaced split.
"""

import jax
import numpy as np
import pytest
import torch

from defensegan_tpu.configs import Config as JaxConfig
from defensegan_tpu.gan import DefenseGAN as JaxGAN
from defensegan_tpu.kernels import fused_projection_v2i as jv2i
from defensegan_torch.ckpt.bridge import load_flax_tree
from defensegan_torch.kernels import build
from defensegan_torch.kernels.fused_projection_v2 import (
    dense_loop_plain, pack_dense, pad_targets)
from defensegan_torch.kernels.fused_projection_v2i import (
    _quant_rows, dense_int8_loop_plain, pack_dense_int8)
from defensegan_torch.kernels.gemm import (COUNTER, EPILOGUES, SLAB, gemm,
                                           gemm_plain, rounding_excess,
                                           split_k_for, split_ranges)
from defensegan_torch.models.generator import generator_for
from test_torch_cuda import GEMM_EDGES, gemm_case
from test_torch_fused_v2 import crop_to_port

torch.set_num_threads(2)

LR, MOM = 10.0, 0.7
LOOP_K = (128, 160, 832, 6272, 8192)     # every K of the loops' products


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cfg = JaxConfig(type="mnist", gen_arch="wide", gen_dim=4, disc_dim=4,
                    latent_dim=32, rec_rr=2, rec_iters=3,
                    compute_dtype="bfloat16",
                    output_dir=str(tmp_path_factory.mktemp("run")))
    jgan = JaxGAN(cfg)
    tg = generator_for("mnist", 4, torch.bfloat16, "wide", 32)
    load_flax_tree(tg, jax.tree.map(np.asarray, jgan.state.gen_params),
                   jax.tree.map(np.asarray, jgan.state.gen_stats))
    return jgan, tg.requires_grad_(False)


@pytest.fixture
def one_thread():
    """Run the test on one intra-op thread, restoring the setting after.

    Both sides of a bit-for-bit comparison must take the same float
    operations. With several threads a float32 product (MKL's sgemm may
    split a 16-row product along K) and a vectorized elementwise op are
    cut into per-thread pieces, whose boundaries follow the team the pool
    hands each call. A full parallel run of the suite (workers importing
    every test file, JAX's threads beside torch's, a loaded machine) once
    saw the two sides round apart at L 1, which the test alone never
    reproduced. On one thread every product and op runs its serial order
    on both sides.
    """
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _inputs(n=16, seed=3):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(np.tanh(rng.randn(n, 784)).astype(np.float32))
    z0 = torch.from_numpy(rng.randn(n, 32).astype(np.float32))
    return x, z0


@pytest.mark.parametrize("field,source", [("dq_k", "dq"), ("dtq_k", "dtq")])
def test_int8_kmajor_copies_are_jax_codes_transposed(pair, field, source):
    jgan, tg = pair
    got = getattr(pack_dense_int8(tg), field).numpy()
    ref = crop_to_port(source, np.asarray(getattr(jv2i.pack_dense_int8(jgan),
                                                  source)), 832).T
    assert got.dtype == np.int8 and got.shape == ref.shape
    assert got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_chained_bf16_products_are_dense_loop_plain(pair, steps,
                                                    one_thread):
    """h = bias_relu(z @ W1), do = tanh_grad(h @ D), dh = relu_mask(do @
    D^T), (z, v, zb) = momentum(dh @ W1^T): bit for bit the plain loop."""
    assert torch.get_num_threads() == 1
    _, tg = pair
    pack = pack_dense(tg)
    x, z0 = _inputs()
    x_pad = pad_targets(pack, x, x.shape[0])
    ref = dense_loop_plain(pack, x_pad, z0, rec_iters=steps, rec_lr=LR,
                           momentum=MOM)
    z, v = z0.clone(), torch.zeros_like(z0)
    zb = z.to(torch.bfloat16)
    for _ in range(steps):
        h = gemm_plain(zb, pack.w1, "bias_relu", bias=pack.b1)
        do = gemm_plain(h, pack.d, "tanh_grad", bias=pack.bd, x=x_pad,
                        scale=2.0 / pack.out_dim)
        dh = gemm_plain(do, pack.dt, "relu_mask", h=h)
        z, v, zb = gemm_plain(dh, pack.w1t, "momentum", z=z, v=v, lr=LR,
                              momentum=MOM)
    assert torch.equal(z, ref)


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_chained_int8_products_are_dense_int8_loop_plain(pair, steps,
                                                         one_thread):
    """The int8 loop as the kernel runs it: h and its row amax from the fc
    epilogue, codes from _quant_rows, both D products on the K-major
    codes with their dequant epilogues: bit for bit the plain loop; the
    epilogues' row amax is the amax _quant_rows takes."""
    assert torch.get_num_threads() == 1
    _, tg = pair
    pack = pack_dense_int8(tg)
    base = pack.base
    x, z0 = _inputs(seed=4)
    x_pad = pad_targets(base, x, x.shape[0])
    ref = dense_int8_loop_plain(pack, x_pad, z0, rec_iters=steps, rec_lr=LR,
                                momentum=MOM)
    z, v = z0.clone(), torch.zeros_like(z0)
    zb = z.to(torch.bfloat16)
    for _ in range(steps):
        h, amax_h = gemm_plain(zb, base.w1, "bias_relu_amax", bias=base.b1)
        hq, sh = _quant_rows(h)
        assert torch.equal(sh[:, 0], torch.clamp_min(amax_h, 1e-30) / 127.0)
        do, amax_g = gemm_plain(hq, pack.dq_k, "tanh_grad_int8",
                                row_scale=sh, col_scale=pack.sd, bias=base.bd,
                                x=x_pad, scale=2.0 / base.out_dim)
        gq, sg = _quant_rows(do)
        assert torch.equal(sg[:, 0], torch.clamp_min(amax_g, 1e-30) / 127.0)
        dh = gemm_plain(gq, pack.dtq_k, "relu_mask_int8", row_scale=sg,
                        col_scale=pack.sdt, h=h)
        z, v, zb = gemm_plain(dh, base.w1t, "momentum", z=z, v=v, lr=LR,
                              momentum=MOM)
    assert torch.equal(z, ref)


@pytest.mark.parametrize("k", LOOP_K)
def test_split_rule_covers_k_with_whole_nonempty_slabs(k):
    for n in (128, 192, 832, 6272):
        splits = split_k_for(k, n)
        assert 1 <= splits <= 16
        assert splits == 1 or n <= 128
        ranges = split_ranges(k, splits)
        assert len(ranges) == splits and ranges[0][0] == 0
        assert ranges[-1][1] == k
        for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert hi == lo2
        assert all(lo % SLAB == 0 and hi > lo for lo, hi in ranges)


def test_split_rule_takes_no_row_count():
    """A row's sums may not depend on the call's rows (chip_smoke.py holds
    192-row chunks bit for bit against one chunk): the rule's only inputs
    are K and N, and it splits the fc backwards of the loops."""
    import inspect
    assert list(inspect.signature(split_k_for).parameters) == ["K", "N"]
    assert split_k_for(6272, 128) == 7          # v2, v2i, v3 fc backward
    assert split_k_for(8192, 128) == 8          # v4 (celeba.yml)
    assert split_k_for(128, 6272) == 1 and split_k_for(160, 256) == 1


@pytest.mark.parametrize("case", list(GEMM_EDGES))
def test_gemm_on_cpu_runs_plain(case):
    """On CPU tensors the wrapper is the plain version and counts no
    launch; each edge case of the card's test is well formed here."""
    epilogue, m, k, n, kind = GEMM_EDGES[case]
    a, b, kw = gemm_case(torch.device("cpu"), epilogue, min(m, 64), k, n,
                         kind, len(case))
    before = build.LAUNCHES[COUNTER]
    got = gemm(a, b, epilogue, **kw)
    assert build.LAUNCHES[COUNTER] == before
    ref = gemm_plain(a, b, epilogue, **kw)
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert torch.equal(g, r)


def test_gemm_rejects_mismatched_operands():
    a = torch.zeros(4, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="chain"):
        gemm(a, torch.zeros(64, 128, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="needs bias"):
        gemm(a, torch.zeros(128, 128, dtype=torch.bfloat16), "bias_relu")
    with pytest.raises(ValueError, match="does not take"):
        gemm(a, torch.zeros(128, 128, dtype=torch.bfloat16), "relu_mask_int8",
             h=torch.zeros(4, 128), row_scale=torch.ones(4),
             col_scale=torch.ones(128))
    assert len(EPILOGUES) == 8


def _split_sum(a, b, splits):
    """The kernel's split-K order: float32 sums per K range, added in
    split order."""
    acc = None
    for lo, hi in split_ranges(a.shape[1], splits):
        part = a[:, lo:hi].float() @ b[lo:hi].float()
        acc = part if acc is None else acc + part
    return acc


def test_band_holds_split_sums_and_catches_a_dropped_slab():
    a, b, kw = gemm_case(torch.device("cpu"), "momentum", 64, 6272, 128,
                         "bf16", 5)
    splits = split_k_for(6272, 128)
    ref = gemm_plain(a, b, "store")
    split = _split_sum(a, b, splits)
    assert rounding_excess(split, ref, a, b, "store") <= 0
    # a slab lost from one split, or a split counted twice, leaves the band
    dropped = split - a[:, :SLAB].float() @ b[:SLAB].float()
    assert rounding_excess(dropped, ref, a, b, "store") > 0
    lo, hi = split_ranges(6272, splits)[1]
    doubled = split + a[:, lo:hi].float() @ b[lo:hi].float()
    assert rounding_excess(doubled, ref, a, b, "store") > 0
    # through the momentum epilogue as well
    ref_m = gemm_plain(a, b, "momentum", **kw)
    got_m = (kw["z"] - kw["lr"] * (kw["momentum"] * kw["v"] + dropped),)
    assert rounding_excess(got_m, ref_m[:1], a, b, "momentum",
                           lr=kw["lr"]) > 0


def test_band_catches_a_shifted_column_pair():
    a, b, kw = gemm_case(torch.device("cpu"), "relu_mask", 64, 832, 256,
                         "bf16", 6)
    ref = gemm_plain(a, b, "relu_mask", **kw)
    assert rounding_excess(ref.clone(), ref, a, b, "relu_mask") <= 0
    shifted = ref.clone()
    shifted[:, 128:130] = ref[:, 130:132]
    assert rounding_excess(shifted, ref, a, b, "relu_mask") > 0
