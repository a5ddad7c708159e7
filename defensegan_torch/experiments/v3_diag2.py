"""v3's step cut after each of its seven sections.

Port of scripts/pallas_v3_diag2.py, the JAX package's section-by-section
bisection of the v3 kernel on the chip: the step body (kernels/
fused_projection_v3.py) at L = 1, truncated after the fc, + conv A,
+ conv B, + the tanh gradient, + conv B's backward, + conv A's backward,
or whole (CUTS), on the mnist.yml generator at tile 64. A truncated step
returns z + 0 * sum(section), which is z itself unless the section holds
an inf or a NaN; the whole step returns z - 10 * dz (lr 10, momentum 0.7
and v = 0, the script's constants and mnist.yml's). The step is v3's with
two roundings changed: conv B's packed product stays float32 and conv A's
backward rounds once, after the sum of its taps (v3 rounds both to bf16
earlier).

`run_cut` runs one cut: on CUDA tensors through the hand-written kernel
(csrc/v3_diag2.cu: v3's step from csrc/fused_projection_v3_step.cuh with
those two switches and the cut, and a two-pass float32 sum), on CPU
tensors through `cut_plain`. Both return the cut's section tensor as well
as z_out, latent-major and flat as the kernel stores it
(kernels/fused_projection_v3.py::s2d_step_plain). `prepare(pack, n,
device)` makes the launch path once (a Diag2Plan: the padded pack, the
workspace, the C plan with its tensor maps and one CUDA graph a cut), so
that `run_cut(plan, x, z0, upto)` is one ctypes call and a graph replay;
a pack alone prepares on the fly. `run_cuts` is the script's run
(scripts/pallas_v3_diag2_torch.py).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import time
import weakref

import torch

from defensegan_torch.experiments.v3_diag import (bind, events_ms, host_ms,
                                                  launch)
from defensegan_torch.kernels import build
from defensegan_torch.kernels.fused_projection_v3 import (
    CUTS, S2DPack, check_targets, pack_s2d, padded_s2d, s2d_step_plain)
from defensegan_torch.kernels.gemm import split_k_for
from defensegan_torch.kernels.grid import pixel_order
from defensegan_torch.kernels.loop import ROW_TILE, round_up

LIBRARY = COUNTER = "v3_diag2"    # the library and its build.LAUNCHES key
LR, MOMENTUM = 10.0, 0.7          # the script's step (pallas_v3_diag2.py)
TILE = 64                         # the script's latents
DEFAULT_CFG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "gans", "mnist.yml")
# a kernel section against the plain version's section computed from the
# kernel's own earlier sections (`given`): the two differ in float32
# summation order, which moves a bf16 rounding by one ulp (2^-7 of the
# value at most) and a float32 sum by far less than 1e-3 of the section's
# largest magnitude; a misplaced tap, mask or pixel moves elements by the
# size of the section's terms
SECTION_ULP = 2.0 ** -7
SECTION_ABS = 1e-3


def cut_plain(pack: S2DPack, x_s2d: torch.Tensor, z0: torch.Tensor,
              upto: str, *, round_obb: bool = False,
              round_taps: bool = False, given=None):
    """Plain PyTorch version of the cut step; returns (z_out, section).

    The script's step: v3's plain step (s2d_step_plain) at lr 10,
    momentum 0.7, v = 0, conv B's product in float32 and conv A's backward
    rounded once (round_obb=True, round_taps=True give v3's own step). A
    cut before "full" returns z0 + 0 * sum(section); "full" returns the
    stepped z and its section is the new v (dz). `given`: as
    s2d_step_plain's.
    """
    z = z0.float()
    z_new, _, sections = s2d_step_plain(
        pack, x_s2d, z, torch.zeros_like(z), rec_lr=LR, momentum=MOMENTUM,
        round_taps=round_taps, round_obb=round_obb, upto=upto, given=given)
    section = sections[upto]
    if upto == "full":
        return z_new, section
    return z + section.sum() * 0.0, section


def _crop(t: torch.Tensor, p2: int, width: int) -> torch.Tensor:
    """[N, p2 * padded] -> [N, p2 * width]: each pixel's first channels."""
    n = t.shape[0]
    return t.reshape(n, p2, -1)[:, :, :width].reshape(n, -1)


_CUT = {upto: i for i, upto in enumerate(CUTS)}     # fpk::v3::Cut
_f32, _bf = torch.float32, torch.bfloat16
_vp, _i32, _fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the plan's extern "C" entries (csrc/v3_diag2.cu) and their ctypes types
ENTRIES = {
    "fp_v3_diag2_plan": ((_vp,) * 25 + (_i32,) * 11 + (_fl,) * 3, _i32),
    "fp_v3_diag2_plan_run": ((_vp,) * 3 + (_i32,) * 2 + (_vp,), _i32),
    "fp_v3_diag2_plan_free": ((_vp,), None),
}


def _entry(name: str):
    argtypes, restype = ENTRIES[name]
    return bind(name, argtypes, LIBRARY, restype)


class Diag2Plan:
    """The cut step's launch path for `n` latents of one pack on one
    device, made once (`prepare`): the padded pack, the pixel order and
    the workspace on the device, and on a card the C plan (the v3 chain
    with its tensor maps encoded once, each cut's launches captured into a
    CUDA graph at its first run). `run` loads z0 and x into its buffers
    (z = z0, v = 0) and runs a cut in one ctypes call, leaving the state a
    fresh `run_cut` leaves; its results are views of the plan's buffers,
    valid until its next run. A CPU plan runs the plain version."""

    def __init__(self, pack: S2DPack, n: int, device):
        self.pack, self.n = pack, int(n)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if self.device.type == "cpu":
            return
        if self.device.type != "cuda":
            raise ValueError(f"a plan on {self.device}: the CPU or a card")
        if any(t.dtype != _bf for t in (pack.w1, pack.ka, pack.kbp)):
            raise ValueError("the kernel takes a bf16 pack")
        if pack.w1.device != self.device:
            raise ValueError(f"pack on {pack.w1.device}, plan on "
                             f"{self.device}")
        dev = self.device
        pp = padded_s2d(pack)
        g, p2 = pp.grid_hw, pp.grid_hw ** 2
        npk, kpk = pp.kbp.shape[1], pp.kbpt.shape[0]
        k, kp, rows = pack.z_dim, pp.z_dim, round_up(self.n, ROW_TILE)
        splits = split_k_for(p2 * pp.c0, kp)          # the fc backward
        order = torch.from_numpy(pixel_order(g)).to(dev)
        weights = [t.contiguous() for t in (
            pp.w1, pp.w1t, pp.b1, pp.ka, pp.kat, pp.ba, pp.kbp, pp.kbpt,
            pp.bb, pp.masks, order)]

        def buf(cols, dt):
            return torch.empty((rows, cols), dtype=dt, device=dev)

        z, v, x = buf(kp, _f32), buf(kp, _f32), buf(p2 * pack.cb, _bf)
        zb, h0, h1 = buf(kp, _bf), buf(p2 * pp.c0, _bf), buf(p2 * pp.ca, _bf)
        obf, dop = buf(p2 * npk, _f32), buf(p2 * kpk, _bf)
        ws = buf(splits * kp, _f32)
        osec, dosec = buf(p2 * pp.cb, _f32), buf(p2 * pp.cb, _bf)
        part = torch.empty(rows, dtype=_f32, device=dev)
        total = torch.empty(1, dtype=_f32, device=dev)
        self._keep = weights + [z, v, x, zb, h0, h1, obf, dop, ws, osec,
                                dosec, part, total]
        n = self.n

        def section(t, width):
            view = t[:n]
            if t.shape[1] == p2 * width:
                return lambda: view
            return lambda: _crop(view, p2, width)

        self.z_out = z[:n, :k]
        full = v[:n, :k]
        self._section = {
            "fc": section(h0, pack.c0), "convA": section(h1, pack.ca),
            "convB": section(osec, pack.cb), "grad": section(dosec, pack.cb),
            "convB_bwd": section(h1, pack.ca),
            "convA_bwd": section(h0, pack.c0), "full": lambda: full}
        handle = ctypes.c_void_p()
        ptrs = [z, v, x] + weights + [zb, h0, h1, obf, dop, ws, osec, dosec,
                                      part, total]
        with torch.cuda.device(dev):
            rc = _entry("fp_v3_diag2_plan")(
                ctypes.byref(handle), *[t.data_ptr() for t in ptrs], rows,
                kp, pp.c0, pp.ca, pp.cb, g, npk, kpk, splits, n, k, LR,
                MOMENTUM, 2.0 / (p2 * pack.cb))
        build.check(build.load(LIBRARY), rc, "v3_diag2 plan")
        self._handle = handle.value
        self._run = _entry("fp_v3_diag2_plan_run")
        # freed with the plan (not at interpreter exit: the context may be
        # gone by then, and the process's end frees it)
        fin = weakref.finalize(self, _entry("fp_v3_diag2_plan_free"),
                               self._handle)
        fin.atexit = False

    def check(self, x_s2d: torch.Tensor, z0_flat: torch.Tensor,
              upto: str) -> None:
        """Raise unless `upto` is a cut, z0 is [n, k] for the plan's n
        latents and its pack's k, x [n, 49*cb], and both lie on its
        device."""
        if upto not in _CUT:
            raise ValueError(f"upto={upto!r} is not one of {CUTS}")
        if z0_flat.shape[0] != self.n:
            raise ValueError(f"the plan takes {self.n} latents, got "
                             f"{z0_flat.shape[0]}")
        if tuple(z0_flat.shape) != (self.n, self.pack.z_dim):
            raise ValueError(f"z0 {tuple(z0_flat.shape)} vs [n, k] = "
                             f"[{self.n}, {self.pack.z_dim}]")
        check_targets(self.pack, x_s2d, z0_flat)
        if z0_flat.device != self.device or x_s2d.device != self.device:
            raise ValueError(f"plan on {self.device}, x on {x_s2d.device}, "
                             f"z0 on {z0_flat.device}: all must be on one "
                             f"device")

    def run(self, x_s2d: torch.Tensor, z0_flat: torch.Tensor, upto: str):
        """One cut (run_cut's contract), on a card a replay of the cut's
        CUDA graph."""
        self.check(x_s2d, z0_flat, upto)
        if self.device.type == "cpu":
            return cut_plain(self.pack, x_s2d, z0_flat, upto)
        return self._launch(x_s2d, z0_flat, upto, graph=True)

    def _launch(self, x_s2d, z0_flat, upto, graph: bool):
        """The cut on the card, checked inputs: the load and the cut's
        graph (graph=True), or the load and the same launches one by one
        (a plan made for one call, which has nothing to replay)."""
        if z0_flat.dtype is not _f32 or not z0_flat.is_contiguous():
            z0_flat = z0_flat.float().contiguous()
        if x_s2d.dtype is not _f32 or not x_s2d.is_contiguous():
            # the kernel reads x in bf16: round once, as x.to(bf16) does
            x_s2d = x_s2d.to(_bf).float().contiguous()
        rc = launch(self._run, [self._handle, z0_flat.data_ptr(),
                                x_s2d.data_ptr(), _CUT[upto], int(graph)],
                    self.device.index)
        if rc:
            build.check(build.load(LIBRARY), rc, f"v3_diag2 upto={upto}")
        build.LAUNCHES[COUNTER] += 1
        return self.z_out, self._section[upto]()


def prepare(pack: S2DPack, n: int, device) -> Diag2Plan:
    """The launch path of the cut step for n latents of `pack` on
    `device`, made once (Diag2Plan)."""
    return Diag2Plan(pack, n, device)


def run_cut(pack, x_s2d: torch.Tensor, z0_flat: torch.Tensor, upto: str):
    """The cut step for all N latents in one call; (z_out [N, k], section
    [N, 49*C]). x_s2d [N, 49*cb] tanh-space targets in s2d-flat order,
    z0_flat [N, k] float32. A CPU tensor runs the plain version, a CUDA
    tensor the kernel (or raises). `pack` is an S2DPack or a Diag2Plan
    (`prepare`): a plan runs on its buffers, replaying the cut's CUDA
    graph, and returns views of them; a pack alone prepares a plan for
    this call and issues its launches one by one."""
    if isinstance(pack, Diag2Plan):
        return pack.run(x_s2d, z0_flat, upto)
    check_targets(pack, x_s2d, z0_flat)
    if upto not in CUTS:
        raise ValueError(f"upto={upto!r} is not one of {CUTS}")
    if z0_flat.device.type == "cpu":
        return cut_plain(pack, x_s2d, z0_flat, upto)
    if pack.w1.device != z0_flat.device or x_s2d.device != z0_flat.device:
        raise ValueError(f"pack on {pack.w1.device}, x on {x_s2d.device}, "
                         f"z0 on {z0_flat.device}: all must be on one "
                         f"device")
    plan = prepare(pack, z0_flat.shape[0], z0_flat.device)
    plan.check(x_s2d, z0_flat, upto)
    return plan._launch(x_s2d, z0_flat, upto, graph=False)


def section_excess(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest excess of |got - ref| over one bf16 ulp of ref plus
    SECTION_ABS of ref's largest magnitude (<= 0: within)."""
    g, r = got.float(), ref.float()
    bound = SECTION_ULP * r.abs() + SECTION_ABS * r.abs().max()
    return ((g - r).abs() - bound).max().item()


def check_sections(pack: S2DPack, x_s2d: torch.Tensor, z0: torch.Tensor,
                   sections: dict) -> dict:
    """Each kernel section (`sections`: cut -> the kernel's section)
    against the plain version's, computed from the kernel's own earlier
    sections, so that every section's arithmetic is held alone:
    {cut: {max_abs_err, excess, ok}}."""
    out, given = {}, {}
    for upto in CUTS:
        got = sections[upto]
        _, ref = cut_plain(pack, x_s2d, z0, upto, given=given)
        excess = section_excess(got, ref)
        out[upto] = {"max_abs_err": (got.float() - ref).abs().max().item(),
                     "excess": excess, "ok": bool(
                         excess <= 0.0 and torch.isfinite(got).all())}
        given[upto] = got
    return out


def diag2_inputs(z_dim: int, out_dim: int, n: int = TILE, seed: int = 0,
                 device="cpu"):
    """The script's inputs from a seed: z0 ~ N(0, 1) [n, k] and x ~ U[0,
    1) [n, out_dim] (float32; the kernel reads x in bf16)."""
    gen = torch.Generator().manual_seed(seed)
    z0 = torch.randn(n, z_dim, generator=gen)
    x = torch.rand(n, out_dim, generator=gen)
    return z0.to(device), x.to(device)


def run_cuts(pack: S2DPack, x_s2d: torch.Tensor, z0: torch.Tensor,
             repeats: int = 3, calls: int = 20) -> list:
    """The script's run: every cut once through `run_cut` on the pack,
    z_out's sum, the section against the plain version's
    (check_sections), z_out against z0 before "full"; then the cut on one
    plan (`prepare`, replaying its graphs on a card) bit for bit against
    those results (plan_equal), and the times: the plan's calls (ms), the
    pack's (fresh_ms) and the plain version (plain_ms) on the host clock
    in turns (v3_diag.host_ms: `calls` calls in a row, median of
    `repeats`), and on a card the plan's device time (v3_diag.events_ms:
    device_ms). One record a cut; a cut that raises or fails a check has
    ok False and its error."""
    dev = z0.device
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    recs, sections, plan = [], {}, None
    for upto in CUTS:
        rec = {"upto": upto}
        try:
            z_out, sections[upto] = run_cut(pack, x_s2d, z0, upto)
            sync()
            rec["sum"] = z_out.sum().item()
            if upto != "full":
                rec["z0_equal"] = bool(torch.equal(z_out, z0))
            else:
                z_ref, _ = cut_plain(pack, x_s2d, z0, upto)
                rec["max_abs_err"] = (z_out - z_ref).abs().max().item()
                rec["moved"] = (z_ref - z0).abs().max().item()
            plan = plan or prepare(pack, z0.shape[0], dev)
            z_plan, s_plan = run_cut(plan, x_s2d, z0, upto)
            rec["plan_equal"] = bool(torch.equal(z_plan, z_out) and
                                     torch.equal(s_plan, sections[upto]))
            fns = {"ms": lambda: run_cut(plan, x_s2d, z0, upto),
                   "fresh_ms": lambda: run_cut(pack, x_s2d, z0, upto),
                   "plain_ms": lambda: cut_plain(pack, x_s2d, z0, upto)}
            rec.update(host_ms(fns, sync, repeats, calls))
            rec["device_ms"] = events_ms(fns["ms"], dev, rec["ms"], repeats,
                                         calls) if cuda else None
            rec["error"] = None
        except Exception as e:           # noqa: BLE001 -- the script's FAIL
            rec["error"] = f"{type(e).__name__}: {str(e)[:160]}"
        recs.append(rec)
    checked = {}
    if len(sections) == len(CUTS):
        checked = check_sections(pack, x_s2d, z0, sections)
    for rec in recs:
        c = checked.get(rec["upto"], {"ok": False})
        rec["section"] = c
        rec["ok"] = bool(rec["error"] is None and c["ok"]
                         and rec.get("z0_equal", True)
                         and rec.get("plan_equal", False))
        if rec["error"] is None and not rec["ok"]:
            rec["error"] = (f"section {c}, z_out != z0 "
                            f"({rec.get('z0_equal')}) or the plan's "
                            f"results != the pack's "
                            f"({rec.get('plan_equal')})")
    return recs


def profile_cut(plan: Diag2Plan, x_s2d: torch.Tensor, z0: torch.Tensor,
                upto: str = "full", runs: int = 20) -> dict:
    """Where a cut's device time goes on its plan: `runs` runs (graph
    replays) under torch.profiler after a warm-up, each kernel's device
    time a run in microseconds by name (the GEMM and the grid conv by
    their epilogue's template), their sum, and the wall time a run of the
    profiled window, host clock."""
    from torch.profiler import ProfilerActivity, profile
    run_cut(plan, x_s2d, z0, upto)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            run_cut(plan, x_s2d, z0, upto)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0 and e.key not in kernels and not e.key.startswith(
                ("cuda", "Memcpy", "Memset", "aten::")):
            kernels[e.key[:120]] = us / runs
    return {"upto": upto, "runs": runs, "kernels_us": kernels,
            "device_us": sum(kernels.values()),
            "wall_us": wall * 1e6 / runs}


def main(argv=None) -> list:
    from defensegan_torch.configs import load_config
    from defensegan_torch.gan import DefenseGAN
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"devices: {torch.cuda.get_device_name(dev)}", flush=True)
    else:
        print(f"devices: {dev} (the plain version)", flush=True)
    gan = DefenseGAN(load_config(DEFAULT_CFG), device=dev)
    pack = pack_s2d(gan.generator)
    z0, x = diag2_inputs(pack.z_dim, pack.grid_hw ** 2 * pack.cb,
                         device=dev)
    # the plain version's times on the CPU are no device metric: one call
    recs = run_cuts(pack, x, z0, **({} if dev.type == "cuda" else
                                    dict(repeats=1, calls=1)))
    for r in recs:
        if r["ok"]:
            extra = (f" max_abs_err={r['max_abs_err']:.3e}"
                     if r["upto"] == "full" else "")
            print(f"PASS upto={r['upto']}: sum={r['sum']:.4e} "
                  f"ms={r['ms']:.4f} fresh_ms={r['fresh_ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} "
                  f"section_err={r['section']['max_abs_err']:.3e}{extra}",
                  flush=True)
        else:
            print(f"FAIL upto={r['upto']}: {r['error']}", flush=True)
    if not all(r["ok"] for r in recs):
        raise SystemExit(1)
    return recs
