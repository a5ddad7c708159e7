"""PyTorch port vs JAX: v3's step cut after each of its sections
(defensegan_torch/experiments/v3_diag2.py against scripts/
pallas_v3_diag2.py).

The JAX script's `build_kernel(pack, upto)` runs as a Pallas kernel in
interpret mode, its TILE patched to 8 latents, on the deep pair of
tests/test_torch_v3_variants.py (gen_dim 4, latent 32, non-trivial
BatchNorm statistics); its rows are pixel-major, the port's latent-major
(converted as that file's `_pixel_major` does). On the CPU the port's
wrapper runs its plain version. A cut before `full` returns z0 + 0 *
sum(section): bit for bit z0 on both sides, and where x holds a NaN the
same NaN pattern. `full` is one step of v3's loop with conv B's product in
float32 and conv A's backward rounded once: z within 1e-5, as v3's tests
hold its loop (both sides round at the same points and differ in float32
summation order; a misplaced tap or mask moves z by ~1e-2). Without its
two rounding changes the plain cut step is v3's plain step bit for bit.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "scripts"))

import pallas_v3_diag2 as jax_diag2  # noqa: E402
from defensegan_tpu.configs import Config as JaxConfig  # noqa: E402
from defensegan_tpu.gan import DefenseGAN as JaxGAN  # noqa: E402
from defensegan_tpu.kernels.fused_projection_v3 import (  # noqa: E402
    pack_s2d as jax_pack)
from defensegan_torch.ckpt.bridge import load_flax_tree  # noqa: E402
from defensegan_torch.experiments import v3_diag2  # noqa: E402
from defensegan_torch.kernels import build  # noqa: E402
from defensegan_torch.kernels.fused_projection_v3 import (  # noqa: E402
    CUTS, pack_s2d, s2d_loop_plain)
from defensegan_torch.models.generator import generator_for  # noqa: E402
from torch_csrc_signatures import c_signatures  # noqa: E402

TILE = 8


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A deep JAX DefenseGAN with non-trivial BatchNorm statistics and the
    port's generator on the same arrays (as test_torch_v3_variants.py)."""
    cfg = JaxConfig(type="mnist", gen_arch="deep", gen_dim=4, disc_dim=4,
                    latent_dim=32, rec_rr=2, rec_iters=1,
                    compute_dtype="bfloat16", projection_kernel="xla",
                    output_dir=str(tmp_path_factory.mktemp("run")))
    jgan = JaxGAN(cfg)
    rng = np.random.RandomState(0)
    stats = jax.tree.map(
        lambda a: np.asarray(a) + 0.5 * rng.rand(*a.shape).astype(np.float32),
        jgan.state.gen_stats)
    params = jax.tree.map(np.asarray, jgan.state.gen_params)
    for name in ("bn_in", "bn_0"):
        params[name]["scale"] = params[name]["scale"] + 0.3 * rng.randn(
            *params[name]["scale"].shape).astype(np.float32)
        params[name]["bias"] = 0.2 * rng.randn(
            *params[name]["bias"].shape).astype(np.float32)
    jgan.state = jgan.state.replace(gen_params=params, gen_stats=stats)
    tg = generator_for("mnist", 4, torch.bfloat16, "deep", 32)
    load_flax_tree(tg, params, stats)
    return jax_pack(jgan), pack_s2d(tg.requires_grad_(False))


def _inputs(seed=0, nan=False):
    """z0 [8, 32] and x [8, 784] in s2d-flat order (bf16 values)."""
    rng = np.random.RandomState(seed)
    z0 = rng.randn(TILE, 32).astype(np.float32)
    x = rng.rand(TILE, 784).astype(np.float32)
    if nan:
        x[3, 5 * 16 + 7] = np.nan           # latent 3, pixel 5, channel 7
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return z0, x


def _pixel_major(x):
    """[N, 49*16] latent-major -> the Pallas kernel's [49*N, 16] rows."""
    n = x.shape[0]
    return x.reshape(n, 49, 16).transpose(1, 0, 2).reshape(49 * n, 16)


def _jax_cut(jp, upto, z0, x, monkeypatch):
    monkeypatch.setattr(jax_diag2, "TILE", TILE)
    kern, _ = jax_diag2.build_kernel(jp, upto)
    f = pl.pallas_call(
        kern, in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 12,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((TILE, jp.z_dim), jnp.float32),
        interpret=True)
    return np.asarray(f(
        jnp.asarray(z0), jnp.asarray(_pixel_major(x), jnp.bfloat16), jp.w1,
        jp.w1t, jnp.repeat(jp.b1, TILE, axis=0), jp.ka, jp.kat, jp.ba,
        jp.kbp, jp.kbpt, jp.bb, jnp.repeat(jp.masks, TILE, axis=0)))


@pytest.mark.parametrize("upto", CUTS)
def test_cut_matches_pallas_interpret(pair, upto, monkeypatch):
    jp, tp = pair
    z0, x = _inputs()
    ref = _jax_cut(jp, upto, z0, x, monkeypatch)
    before = build.LAUNCHES[v3_diag2.COUNTER]
    got, section = v3_diag2.run_cut(tp, torch.from_numpy(x),
                                    torch.from_numpy(z0), upto)
    assert build.LAUNCHES[v3_diag2.COUNTER] == before   # the plain version
    assert torch.isfinite(section).all()
    got = got.numpy()
    if upto == "full":
        assert np.abs(ref - z0).max() > 5e-3                # the step moved z
        np.testing.assert_allclose(got, ref, atol=1e-5)
    else:
        np.testing.assert_array_equal(ref, z0)
        np.testing.assert_array_equal(got, z0)


@pytest.mark.parametrize("upto", CUTS)
def test_nan_in_x_reaches_the_same_outputs(pair, upto, monkeypatch):
    """One NaN in x: the cuts before the tanh gradient return z0, the
    summed cuts after it all NaN, the whole step NaN in that latent's row;
    the same pattern on both sides."""
    jp, tp = pair
    z0, x = _inputs(seed=1, nan=True)
    ref = _jax_cut(jp, upto, z0, x, monkeypatch)
    got, _ = v3_diag2.run_cut(tp, torch.from_numpy(x), torch.from_numpy(z0),
                              upto)
    got = got.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    if CUTS.index(upto) < CUTS.index("grad"):
        np.testing.assert_array_equal(got, z0)
    elif upto != "full":
        assert np.isnan(got).all()
    else:
        assert np.isnan(got[3]).all() and not np.isnan(np.delete(got, 3, 0)
                                                       ).any()


def test_plain_cut_with_v3_roundings_is_v3_bit_for_bit(pair):
    """The two rounding changes are the only difference from v3's step:
    switched back, the whole cut step equals v3's plain loop at L 1."""
    _, tp = pair
    z0, x = _inputs(seed=2)
    xt, zt = torch.from_numpy(x), torch.from_numpy(z0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)           # one summation order on both sides
    try:
        ref = s2d_loop_plain(tp, xt, zt, rec_iters=1, rec_lr=v3_diag2.LR,
                             momentum=v3_diag2.MOMENTUM)
        got, _ = v3_diag2.cut_plain(tp, xt, zt, "full", round_obb=True,
                                    round_taps=True)
        assert torch.equal(got, ref)
        changed, _ = v3_diag2.cut_plain(tp, xt, zt, "full")
        assert not torch.equal(changed, ref)
    finally:
        torch.set_num_threads(threads)


def test_sections_have_the_kernels_layout(pair):
    _, tp = pair
    z0, x = _inputs()
    widths = {"fc": tp.c0, "convA": tp.ca, "convB": tp.cb, "grad": tp.cb,
              "convB_bwd": tp.ca, "convA_bwd": tp.c0}
    for upto in CUTS:
        _, s = v3_diag2.run_cut(tp, torch.from_numpy(x),
                                torch.from_numpy(z0), upto)
        assert s.shape == ((TILE, 32) if upto == "full"
                           else (TILE, 49 * widths[upto]))


def test_check_sections_holds_the_plain_sections_and_catches_a_moved_tap(
        pair):
    _, tp = pair
    z0, x = (torch.from_numpy(a) for a in _inputs())
    sections = {u: v3_diag2.cut_plain(tp, x, z0, u)[1] for u in CUTS}
    assert all(r["ok"] for r in v3_diag2.check_sections(
        tp, x, z0, sections).values())
    moved = dict(sections)                     # conv A's output one pixel on
    moved["convA"] = torch.roll(sections["convA"], tp.ca, dims=1)
    res = v3_diag2.check_sections(tp, x, z0, moved)
    assert res["fc"]["ok"] and not res["convA"]["ok"]


def test_run_cut_rejects_a_cut_or_targets_it_does_not_have(pair):
    _, tp = pair
    z0, x = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="upto"):
        v3_diag2.run_cut(tp, x, z0, "conv_c")
    with pytest.raises(ValueError, match="out_dim"):
        v3_diag2.run_cut(tp, x[:, :700], z0, "fc")


@pytest.mark.parametrize("upto", CUTS)
def test_plan_equals_fresh_calls_bit_for_bit(pair, upto):
    """prepare + run_cut equals run_cut on the pack, bit for bit, for the
    cut run twice on one plan with the whole step between (no state
    leaks from one run to the next), on other inputs after; nothing
    launched on the CPU."""
    _, tp = pair
    plan = v3_diag2.prepare(tp, TILE, "cpu")
    before = build.LAUNCHES[v3_diag2.COUNTER]
    for seed in (0, 0, 3):
        z0, x = (torch.from_numpy(a) for a in _inputs(seed))
        ref = v3_diag2.run_cut(tp, x, z0, upto)
        for first in ("full", upto):
            v3_diag2.run_cut(plan, x, z0, first)
        got = v3_diag2.run_cut(plan, x, z0, upto)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert build.LAUNCHES[v3_diag2.COUNTER] == before


def test_plan_refuses_another_n_device_or_pack(pair):
    _, tp = pair
    z0, x = (torch.from_numpy(a) for a in _inputs())
    plan = v3_diag2.prepare(tp, TILE, "cpu")
    with pytest.raises(ValueError, match="latents"):
        v3_diag2.run_cut(plan, x[:TILE - 1], z0[:TILE - 1], "fc")
    with pytest.raises(ValueError, match="one device"):
        v3_diag2.run_cut(plan, x.to("meta"), z0.to("meta"), "fc")
    with pytest.raises(ValueError, match="one device"):
        v3_diag2.run_cut(plan, x, z0.to("meta"), "fc")
    # inputs shaped for another pack: z0 of another k, x of another width
    with pytest.raises(ValueError, match=r"\[n, k\]"):
        v3_diag2.run_cut(plan, x, z0[:, :-1], "fc")
    with pytest.raises(ValueError, match="out_dim"):
        v3_diag2.run_cut(plan, x[:, :-tp.cb], z0, "fc")
    with pytest.raises(ValueError, match="the CPU or a card"):
        v3_diag2.prepare(tp, TILE, "meta")
    with pytest.raises(ValueError, match="upto"):
        v3_diag2.run_cut(plan, x, z0, "conv_c")


def test_plan_entries_match_the_c_signatures():
    """The plan's ctypes bindings (ENTRIES) are csrc/v3_diag2.cu's
    extern "C" entries, parameter for parameter."""
    entries = c_signatures("v3_diag2.cu")
    for name, (argtypes, restype) in v3_diag2.ENTRIES.items():
        assert entries[name] == (restype, list(argtypes)), name


def test_script_runs_every_cut_on_the_cpu():
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "pallas_v3_diag2_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    passed = [ln for ln in r.stdout.splitlines() if ln.startswith("PASS ")]
    assert [ln.split(":")[0][len("PASS upto="):] for ln in passed] == \
        list(CUTS)


def test_script_exits_nonzero_when_a_cut_fails(monkeypatch, capsys):
    real = v3_diag2.run_cut

    def broken(pack, x, z0, upto):
        if upto == "grad":
            raise RuntimeError("launch refused")
        return real(pack, x, z0, upto)

    monkeypatch.setattr(v3_diag2, "run_cut", broken)
    with pytest.raises(SystemExit) as e:
        v3_diag2.main(["--device", "cpu"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "FAIL upto=grad: RuntimeError: launch refused" in out
