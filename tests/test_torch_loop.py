"""The library-loop layer (defensegan_torch/kernels/loop.py) under the four
fused loops, on the CPU.

Each loop's reconstructor builds its LoopState once and hands that same
object to `run_loop` on every request: no request builds a state, so none
pads a weight or uploads a host table. `run_loop` itself needs a card, so
it is replaced by a stand-in here; z0 on the meta device takes the loops'
kernel branch, and the stand-in answers on the CPU. Each state's argument
list is held against its C entry's parameters, read from the source.
"""

import ctypes
import pathlib
import re
import sys
import types

import pytest
import torch

from defensegan_torch.kernels import build, loop
from defensegan_torch.kernels import fused_projection_v2 as v2
from defensegan_torch.kernels import fused_projection_v2i as v2i
from defensegan_torch.kernels import fused_projection_v3 as v3
from defensegan_torch.kernels import fused_projection_v4 as v4
from defensegan_torch.models.generator import generator_for

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from torch_csrc_signatures import c_signatures  # noqa: E402

torch.set_num_threads(2)

RR = 2
# each loop: its module, reconstructor, the function that makes its state
# and what that calls (none may run after construction), its generator and
# image shape
CASES = {
    "v2": (v2, v2.make_dense_reconstructor,
           ("dense_state", "padded_fc"), ("mnist", 4, "wide", 16),
           (28, 28, 1)),
    "v2i": (v2i, v2i.make_dense_int8_reconstructor,
            ("dense_int8_state", "padded_fc"), ("mnist", 4, "wide", 16),
            (28, 28, 1)),
    "v3": (v3, v3.make_s2d_reconstructor,
           ("s2d_state", "padded_s2d", "pixel_order"),
           ("mnist", 4, "deep", 16), (28, 28, 1)),
    "v4": (v4, v4.make_v4_reconstructor,
           ("v4_state", "padded_v4", "pixel_order", "tap_masks"),
           ("celeba", 2, "deep", 8), (64, 64, 3)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reconstructor_hands_one_state_to_every_request(name, monkeypatch):
    mod, make, makers, (data, dim, arch, latent), shape = CASES[name]
    gen = generator_for(data, dim, torch.bfloat16, arch, latent,
                        gen=torch.Generator().manual_seed(0))
    gen.requires_grad_(False)
    seen = []

    def fake_run_loop(state, x_pad, z0, **kw):
        seen.append((state, x_pad.device, kw))
        return torch.zeros(tuple(z0.shape))

    monkeypatch.setattr(mod, "run_loop", fake_run_loop)
    for counter in ("LAUNCHES", "SLABS"):
        monkeypatch.setattr(build, counter, getattr(build, counter).copy())
    run = make(gen, shape, rec_rr=RR, rec_iters=3, rec_lr=1.0, momentum=0.7)

    def built_per_request(*a, **kw):
        raise AssertionError("a request built kernel state")

    for maker in makers:
        monkeypatch.setattr(mod, maker, built_per_request)
    x = torch.rand((3,) + shape, generator=torch.Generator().manual_seed(1))
    z0 = torch.zeros(3, RR, latent, device="meta")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        first = run(x, z0=z0)
    second = run(x, z0=z0)
    assert first.x_hat.shape == second.x_hat.shape == (3,) + shape
    (state, dev, kw), (again, _, _) = seen
    assert isinstance(state, loop.LoopState) and again is state
    assert dev.type == "cpu" and kw["rec_iters"] == 3
    # one staging span a request, before the selection
    names = [e.name for e in prof.events()
             if e.name.startswith("projection.")]
    assert names == ["projection.stage", "projection.select"]
    # what run_loop binds is the C entry's parameter list
    restype, params = c_signatures(state.library + ".cu")[state.entry]
    assert restype is ctypes.c_int and params == loop.argtypes(state)
    assert state.library == "fused_projection_" + name
    # v3 on the deep MNIST generator takes its fused conv B entry, counted
    # under its own key
    assert state.counter == (v3.FUSED_COUNTER if name == "v3" else None)
    tensors = [t for t in state.weights + state.keep
               if isinstance(t, torch.Tensor)]
    assert all(t.is_contiguous() and t.device.type == "cpu"
               for t in tensors)


def test_each_entry_is_bound_once(monkeypatch):
    """run_loop sets an entry's ctypes signature when it first binds it
    and never again: one binding per (library, entry)."""
    gen = generator_for("mnist", 4, torch.bfloat16, "wide", 16)
    dense = v2.dense_state(v2.pack_dense(gen))
    int8 = v2i.dense_int8_state(v2i.pack_dense_int8(gen))
    sets = []

    class Entry:
        argtypes = None      # a ctypes function's, until it is bound

        def __setattr__(self, field, value):
            sets.append(field)
            super().__setattr__(field, value)

    lib = types.SimpleNamespace(fp_v2_run=Entry(), fp_v2i_run=Entry())
    for _ in range(3):
        assert loop._entry(lib, dense) is lib.fp_v2_run
        assert loop._entry(lib, int8) is lib.fp_v2i_run
    assert sets == ["argtypes", "restype"] * 2
    assert lib.fp_v2_run.argtypes == loop.argtypes(dense)
    assert lib.fp_v2i_run.restype is ctypes.c_int


@pytest.mark.parametrize("scratch,rows", [
    # v2 on the flagship: 30592 bytes a row, one call up to 35072 rows
    (((128, torch.bfloat16), (6272, torch.bfloat16), (832, torch.bfloat16),
      (6272, torch.bfloat16), (7 * 128, torch.float32)), 35072),
    # a row as large as SCRATCH_CAP still runs one ROW_TILE a call
    (((1 << 28, torch.float32),), 64)])
def test_default_chunk_keeps_the_scratch_under_its_cap(scratch, rows):
    assert loop.default_chunk(scratch) == rows
    row_bytes = sum(c * dt.itemsize for c, dt in scratch)
    assert rows % loop.ROW_TILE == 0
    assert rows * row_bytes <= loop.SCRATCH_CAP or rows == loop.ROW_TILE



# the grid convs' one-tile form (csrc/conv3x3_sm90.cuh): the library that
# launched them reports it, and run_loop counts a call under
# loop.ONE_TILE_COUNTER from that report
def _sources(source: str) -> set:
    """The source and every csrc header it includes, transitively."""
    seen, todo = set(), [source]
    while todo:
        name = todo.pop()
        if name not in seen:
            seen.add(name)
            text = (pathlib.Path(build.CSRC) / name).read_text()
            todo += re.findall(r'#include "([\w.]+)"', text)
    return seen


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_loop_with_grid_convs_reports_their_one_tile_form(name):
    """v3's and v4's libraries hold the grid conv, and with it the count
    fp_one_tile_launches that run_loop reads; v2's and v2i's hold
    neither, so their calls are never counted under ONE_TILE_COUNTER."""
    sources = _sources(f"fused_projection_{name}.cu")
    entries = {e for s in sources for e in c_signatures(s)}
    convs = name in ("v3", "v4")
    assert ("conv3x3_sm90.cuh" in sources) == convs
    assert ("fp_one_tile_launches" in entries) == convs


def test_one_tile_launches_reads_the_library_report():
    """build.one_tile_launches returns the library's own count, typed as
    the C side declares it, and 0 for a library without grid convs."""
    assert c_signatures("conv3x3_sm90.cuh")["fp_one_tile_launches"] == \
        (ctypes.c_longlong, [])
    assert build.one_tile_launches(
        types.SimpleNamespace(fp_one_tile_launches=lambda: 7)) == 7
    assert build.one_tile_launches(types.SimpleNamespace()) == 0
