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
(kernels/fused_projection_v3.py::s2d_step_plain). `run_cuts` is the
script's run (scripts/pallas_v3_diag2_torch.py).
"""

from __future__ import annotations

import argparse
import ctypes
import os

import torch

from defensegan_torch.experiments.v3_diag import device_ms
from defensegan_torch.kernels import build
from defensegan_torch.kernels.fused_projection_v2 import (ROW_TILE,
                                                          _round_up, pad_to)
from defensegan_torch.kernels.fused_projection_v3 import (
    CUTS, S2DPack, check_targets, pack_s2d, padded_s2d, pixel_order,
    s2d_step_plain)
from defensegan_torch.kernels.gemm import split_k_for

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


def run_cut(pack: S2DPack, x_s2d: torch.Tensor, z0_flat: torch.Tensor,
            upto: str):
    """The cut step for all N latents in one call; (z_out [N, k], section
    [N, 49*C]). x_s2d [N, 49*cb] tanh-space targets in s2d-flat order,
    z0_flat [N, k] float32. A CPU tensor runs the plain version, a CUDA
    tensor the kernel (or raises)."""
    check_targets(pack, x_s2d, z0_flat)
    if upto not in CUTS:
        raise ValueError(f"upto={upto!r} is not one of {CUTS}")
    if z0_flat.device.type == "cpu":
        return cut_plain(pack, x_s2d, z0_flat, upto)
    dev = z0_flat.device
    if pack.w1.device != dev or x_s2d.device != dev:
        raise ValueError(f"pack on {pack.w1.device}, x on {x_s2d.device}, "
                         f"z0 on {dev}: all must be on one device")
    pp = padded_s2d(pack)
    g, p2 = pp.grid_hw, pp.grid_hw ** 2
    npk, kpk = pp.kbp.shape[1], pp.kbpt.shape[0]
    n, k = z0_flat.shape
    kp, rows = pp.z_dim, _round_up(n, ROW_TILE)
    splits = split_k_for(p2 * pp.c0, kp)          # the fc backward
    f32, bf = torch.float32, torch.bfloat16
    z = torch.zeros((rows, kp), dtype=f32, device=dev)
    z[:n, :k] = z0_flat
    v = torch.zeros_like(z)
    x = pad_to(x_s2d.to(bf), 0, ROW_TILE).contiguous()
    order = torch.from_numpy(pixel_order(g)).to(dev)
    weights = [pp.w1, pp.w1t, pp.b1, pp.ka, pp.kat, pp.ba, pp.kbp, pp.kbpt,
               pp.bb, pp.masks, order]
    if any(t.dtype != bf for t in (pp.w1, pp.ka, pp.kbp)):
        raise ValueError("the kernel takes a bf16 pack")
    weights = [t.contiguous() for t in weights]

    def buf(cols, dt):
        return torch.empty((rows, cols), dtype=dt, device=dev)

    zb, h0, h1 = buf(kp, bf), buf(p2 * pp.c0, bf), buf(p2 * pp.ca, bf)
    obf, dop, ws = buf(p2 * npk, f32), buf(p2 * kpk, bf), buf(splits * kp,
                                                               f32)
    osec, dosec = buf(p2 * pp.cb, f32), buf(p2 * pp.cb, bf)
    part = torch.empty(rows, dtype=f32, device=dev)
    total = torch.empty(1, dtype=f32, device=dev)
    ptrs = [z, v, x] + weights + [zb, h0, h1, obf, dop, ws, osec, dosec,
                                  part, total]
    lib = build.load(LIBRARY)
    fn = lib.fp_v3_diag2_run
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 10 + \
        [ctypes.c_float] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(*[t.data_ptr() for t in ptrs], rows, kp, pp.c0, pp.ca, pp.cb,
                g, npk, kpk, splits, CUTS.index(upto), LR, MOMENTUM,
                2.0 / (p2 * pack.cb),
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, f"v3_diag2 upto={upto}")
    build.LAUNCHES[COUNTER] += 1
    section = {"fc": lambda: _crop(h0, p2, pack.c0),
               "convA": lambda: _crop(h1, p2, pack.ca),
               "convB": lambda: osec, "grad": lambda: dosec,
               "convB_bwd": lambda: _crop(h1, p2, pack.ca),
               "convA_bwd": lambda: _crop(h0, p2, pack.c0),
               "full": lambda: v[:, :k]}[upto]()
    return z[:n, :k], section[:n]


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
             repeats: int = 3) -> list:
    """The script's run: every cut once through `run_cut`, z_out's sum,
    the section against the plain version's (check_sections), z_out
    against z0 before "full", then the kernel's and the plain version's
    times (v3_diag.device_ms: median of `repeats` single calls). One record a cut; a cut that raises or
    fails a check has ok False and its error."""
    dev = z0.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    recs, sections = [], {}
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
            rec["ms"] = device_ms(lambda: run_cut(pack, x_s2d, z0, upto),
                                  sync, repeats, calls=1)
            rec["plain_ms"] = device_ms(
                lambda: cut_plain(pack, x_s2d, z0, upto), sync, repeats,
                calls=1)
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
                         and rec.get("z0_equal", True))
        if rec["error"] is None and not rec["ok"]:
            rec["error"] = (f"section {c} or z_out != z0 "
                            f"({rec.get('z0_equal')})")
    return recs


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
    recs = run_cuts(pack, x, z0, repeats=3 if dev.type == "cuda" else 1)
    for r in recs:
        if r["ok"]:
            extra = (f" max_abs_err={r['max_abs_err']:.3e}"
                     if r["upto"] == "full" else "")
            print(f"PASS upto={r['upto']}: sum={r['sum']:.4e} "
                  f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                  f"section_err={r['section']['max_abs_err']:.3e}{extra}",
                  flush=True)
        else:
            print(f"FAIL upto={r['upto']}: {r['error']}", flush=True)
    if not all(r["ok"] for r in recs):
        raise SystemExit(1)
    return recs
