"""v2's slab lists (kernels/gemm.py::slab_list, carried by
kernels/fused_projection_v2.py::pack_dense), on the CPU.

The kernel's h @ D and do @ D^T walk, for each 128-column tile, only the
64-deep K slabs whose block of D (D^T) holds a nonzero. These tests hold
the lists against D itself, emulate the kernel's walk in float32 (listed
slabs against every slab, bit for bit), and check what the wrapper hands
the library and counts (build.SLABS). The kernel itself is held against
the dense product on the card by tests/test_torch_cuda.py.
"""

import pathlib

import pytest
import torch

from defensegan_torch.kernels import build
from defensegan_torch.kernels import fused_projection_v2 as v2
from defensegan_torch.kernels.gemm import SLAB, TILE_M, TILE_N, slab_list
from defensegan_torch.kernels.loop import argtypes
from defensegan_torch.models.generator import generator_for

ROOT = pathlib.Path(__file__).resolve().parents[1]
# (listed blocks, all blocks) of D and D^T on mnist_fast.yml's generator
# (GEN_DIM 16, wide: F 6272, P 832), a structural count
FLAGSHIP = {"d": (182, 686), "dt": (142, 637)}


def _seeded(dim=16, latent=128):
    return generator_for("mnist", dim, torch.bfloat16, "wide", latent,
                         gen=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def flagship_pack():
    return v2.pack_dense(_seeded())


def _trained_generator():
    from defensegan_torch.configs import load_config
    from defensegan_torch.gan import DefenseGAN
    run = str(ROOT / "output" / "gans" / "mnist_fast")
    cfg = load_config(run, {"COMPUTE_DTYPE": "bfloat16"})
    return DefenseGAN(cfg.replace(output_dir=run), device="cpu").load() \
        .generator


def _blocks(b):
    """{(tile, slab)} of the blocks of b [K, N] that hold a nonzero, block
    by block."""
    k, n = b.shape
    tiles, slabs = -(-n // TILE_N), -(-k // SLAB)
    return {(t, s) for t in range(tiles) for s in range(slabs)
            if b[s * SLAB:(s + 1) * SLAB, t * TILE_N:(t + 1) * TILE_N]
            .any()}


def _listed(sl):
    off, idx = sl.off.tolist(), sl.idx.tolist()
    return [idx[off[t]:off[t + 1]] for t in range(len(off) - 1)]


@pytest.mark.parametrize("weights", ["seeded", "trained"])
def test_lists_count_the_flagships_blocks(flagship_pack, weights):
    pack = flagship_pack if weights == "seeded" else \
        v2.pack_dense(_trained_generator())
    assert tuple(pack.d.shape) == (6272, 832)
    for name in ("d", "dt"):
        sl = getattr(pack, f"{name}_slabs")
        assert (sl.issued, sl.dense) == FLAGSHIP[name], name
        assert sl.off.dtype == sl.idx.dtype == torch.int32
        assert sl.off[-1].item() == sl.idx.numel() == sl.issued


@pytest.mark.parametrize("dim", [4, 16])
@pytest.mark.parametrize("name", ["d", "dt"])
def test_every_nonzero_block_is_listed_and_no_other(dim, name):
    """gen_dim 4 has F 1568: a ragged last K slab of D and a ragged last
    tile of D^T."""
    pack = v2.pack_dense(_seeded(dim, 32))
    b = getattr(pack, name)
    sl = getattr(pack, f"{name}_slabs")
    lists = _listed(sl)
    assert len(lists) == -(-b.shape[1] // TILE_N) == sl.off.numel() - 1
    assert all(t == sorted(set(t)) for t in lists)    # increasing
    got = {(t, s) for t, slabs in enumerate(lists) for s in slabs}
    assert got == _blocks(b)
    assert sl.off[-1].item() == sl.issued == len(got)


def _walk(a, b, lists):
    """The kernel's walk in float32: per 128-column tile, the slabs' sums
    added in walk order, the first one as it is (scale_d 0), a tile with
    no slab zero. lists None: every slab."""
    k, n = b.shape
    slabs = -(-k // SLAB)
    out = torch.zeros(a.shape[0], n)
    for t in range(-(-n // TILE_N)):
        cols = slice(t * TILE_N, min((t + 1) * TILE_N, n))
        acc = None
        for s in (range(slabs) if lists is None else lists[t]):
            rows = slice(s * SLAB, (s + 1) * SLAB)
            part = a[:, rows].float() @ b[rows, cols].float()
            acc = part if acc is None else acc + part
        if acc is not None:
            out[:, cols] = acc
    return out


def _operand(pack, name, m=64, seed=0):
    """A of the product: h = relu(.) in bf16 (exact zeros included) for
    h @ D, a signed do for do @ D^T."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(m, getattr(pack, name).shape[0], generator=g)
    return (torch.relu(a) if name == "d" else 0.01 * a).to(torch.bfloat16)


@pytest.mark.parametrize("name", ["d", "dt"])
def test_listed_walk_equals_the_dense_walk_bit_for_bit(flagship_pack, name):
    b = getattr(flagship_pack, name)
    a = _operand(flagship_pack, name)
    lists = _listed(getattr(flagship_pack, f"{name}_slabs"))
    listed, dense = _walk(a, b, lists), _walk(a, b, None)
    assert listed.abs().max() > 0
    assert torch.equal(listed.view(torch.int32), dense.view(torch.int32))


@pytest.mark.parametrize("cut", ["block", "tile"])
def test_a_zeroed_block_drops_from_the_list(flagship_pack, cut):
    """One listed block of D zeroed on purpose leaves the list; a tile
    zeroed whole gets an empty list, and its sums are zeros on both
    walks."""
    d = flagship_pack.d.clone()
    lists = _listed(flagship_pack.d_slabs)
    t, s = 2, lists[2][3]
    if cut == "block":
        d[s * SLAB:(s + 1) * SLAB, t * TILE_N:(t + 1) * TILE_N] = 0
    else:
        d[:, t * TILE_N:(t + 1) * TILE_N] = 0
    sl = slab_list(d)
    got = _listed(sl)
    want = [x for x in lists[t] if x != s] if cut == "block" else []
    assert got[t] == want
    assert got[:t] + got[t + 1:] == lists[:t] + lists[t + 1:]
    assert sl.issued == 182 - (len(lists[t]) - len(want))
    a = _operand(flagship_pack, "d", seed=1)
    listed = _walk(a, d, got)
    assert torch.equal(listed.view(torch.int32),
                       _walk(a, d, None).view(torch.int32))
    if cut == "tile":
        assert not listed[:, t * TILE_N:(t + 1) * TILE_N].any()


def _m_tiles(rows):
    return -(-rows // TILE_M)


@pytest.mark.parametrize("n, chunk, m_tiles", [
    (10, None, 1), (64, None, 1), (10240, None, 80),
    # two library calls: 200 rows pad to 256, cut 192 + 64
    (200, 192, _m_tiles(192) + _m_tiles(64))])
def test_wrapper_hands_the_packs_lists_and_counts_them(
        flagship_pack, monkeypatch, n, chunk, m_tiles):
    """At every row count the library gets the pack's own lists after the
    six padded weights, and build.SLABS adds, per call, its 128-row tiles
    x L x the listed (and all) slabs: 26.5% of h @ D's, 22.3% of do @
    D^T's. The run goes to a stand-in of run_loop (the library needs a
    card), on meta tensors, which take the kernel's branch."""
    calls = []

    def fake_run_loop(state, x_pad, z0, **kw):
        calls.append((state, kw))
        return torch.zeros_like(z0)

    monkeypatch.setattr(v2, "run_loop", fake_run_loop)
    for counter in ("LAUNCHES", "SLABS"):
        monkeypatch.setattr(build, counter, getattr(build, counter).copy())
    build.reset_launches()
    pack = flagship_pack
    meta = torch.device("meta")
    v2.fused_projection_dense(
        pack, torch.zeros(n, 784, device=meta),
        torch.zeros(n, 128, device=meta), rec_iters=7, rec_lr=10.0,
        momentum=0.7, chunk=chunk)
    (state, kw), = calls
    assert state.library == "fused_projection_v2" and \
        state.dims == (128, 6272, 832, 7)
    lists = pack.d_slabs[:2] + pack.dt_slabs[:2]
    assert len(state.weights) == 10 and all(
        w is t for w, t in zip(state.weights[6:], lists))
    assert kw["chunk"] == chunk if chunk else kw["chunk"] >= n
    assert dict(build.SLABS) == {
        "h@D.issued": m_tiles * 7 * 182, "h@D.dense": m_tiles * 7 * 686,
        "do@Dt.issued": m_tiles * 7 * 142, "do@Dt.dense": m_tiles * 7 * 637}
    build.reset_launches()
    assert not any(build.SLABS.values())


def test_v2_entry_takes_the_lists_in_its_c_signature(flagship_pack,
                                                     monkeypatch):
    """fp_v2_run's parameters, read from the source, are what run_loop
    binds for v2's arguments: z, v, x, the ten weights (the four list
    pointers after bd), five scratch buffers, M and the four widths,
    iters, three floats, the stream."""
    import ctypes
    import sys
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_csrc_signatures import c_signatures
    calls = []
    monkeypatch.setattr(v2, "run_loop",
                        lambda *a, **kw: calls.append(a) or a[2])
    meta = torch.device("meta")
    v2.fused_projection_dense(
        flagship_pack, torch.zeros(64, 784, device=meta),
        torch.zeros(64, 128, device=meta), rec_iters=1, rec_lr=1.0,
        momentum=0.7)
    state = calls[0][0]
    restype, params = c_signatures("fused_projection_v2.cu")[state.entry]
    want = [ctypes.c_void_p] * (3 + len(state.weights) +
                                len(state.scratch)) + \
        [ctypes.c_int] * (2 + len(state.dims)) + [ctypes.c_float] * 3 + \
        [ctypes.c_void_p]
    assert restype is ctypes.c_int and params == want == argtypes(state)


def test_profile_counts_the_listed_slabs_as_issued(flagship_pack):
    """scripts/torch_kernel_profile.py's issued operations of v2's D
    products are the listed slabs' (a pack without lists, as a parent
    checkout's, counts every slab)."""
    import sys
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_kernel_profile as kprof
    h_d, do_dt = kprof.V2_LAUNCHES[1:3]
    per_block = 2.0 * 128 * 2 * SLAB * TILE_N      # 128 rows, L 2
    ops = kprof.issued("fused_projection_v2", flagship_pack, 128, 2)
    assert ops[h_d][0] == per_block * 182 and ops[do_dt][0] == \
        per_block * 142
    dense = kprof.issued("fused_projection_v2",
                         flagship_pack._replace(d_slabs=None), 128, 2)
    assert dense[h_d][0] == per_block * 686
