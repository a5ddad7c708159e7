#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — defended inference on the flagship
configuration (configs/gans/mnist_fast.yml: wide generator, k 128,
F 6272, 784 outputs padded to P 832; trained step-20000 weights from the
committed numpy export) — and holds every kernel of that path against its
plain PyTorch version:

  1. device: the card's name and power limit; builds the CUDA kernels
     from csrc/ (one nvcc per source, concurrently)
  2. load: DefenseGAN on cuda from output/gans/mnist_fast/export
  3. kernels vs plain versions at full width:
       a. z_final after L = 1 and L = 5 steps, elementwise; and 192-row
          chunks (the last one short) bit for bit against one chunk
       b. L = 200, R = 10 at the timed shape, 1024 images (512 clean, 512
          with +-0.1 noise): [B, R] final losses by the tie-aware
          measure, each kernel against its own plain version;
          int8 against the fp32 plain path with the bf16 kernel as the
          control (the int8_gate.json criterion)
  4. serving: DefendedPipeline (classifier E, seeded random init: no
     trained classifier is in the repository) calibrate + predict with
     PROJECTION_KERNEL auto (-> v2), pallas_int8 (-> v2i) and
     rec_init=encoder; both kernels' launch counters must rise
  5. timing at 1024 images x R 10 x L 200 (median of 3, synchronized):
     each kernel, its plain version, the fp32 plain path, and the
     library yardstick (the same loop on torch.matmul / torch._int_mm)
  6. the `kernels` line, then {"ok": true, "device": {...}} last.

Every phase prints one JSON line; any failed check exits nonzero. There is
no CPU fallback: without a CUDA device the script exits 2 and prints no
result. The full record also goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(ROOT, "output", "gans", "mnist_fast")

# Published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12

# (a) elementwise tolerance on z_final, relative to how far the plain
# version moved z: kernel and plain version differ only in f32 summation
# order, which flips a bf16 rounding of an intermediate (one bf16 ulp is
# 2^-8 = 3.9e-3 relative) in a small share of elements; lr = 10 momentum
# steps carry the flips forward, so the bound grows with L.
ELEMENTWISE_TOL = {1: 4e-3, 5: 2e-2}
# (b) restart selection of a kernel against its own plain version:
# material disagreement and best-loss p95 |delta| (the bf16 tie tau)
MATERIAL_MAX = 0.03
P95_MAX = 2e-3
# (4) mean best-restart tanh-space MSE on clean G(z) requests: an
# unrelated digit scores ~0.3 (printed beside it), a recovered one ~1e-3
CLEAN_LOSS_MAX = 0.02

RECORD: dict = {}


def emit(phase: str, **kw) -> None:
    RECORD[phase] = kw
    print(json.dumps(dict(phase=phase, **kw)), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def median_ms(fn, repeats: int = 3) -> float:
    import torch
    fn()                                   # warm-up (and first-use build)
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def library_loop_v2(pack, x_pad, z0, *, rec_iters, rec_lr, momentum):
    """The v2 loop on torch.matmul in bf16 (cuBLAS): the yardstick only."""
    import torch
    bf = torch.bfloat16
    z = z0.clone()
    v = torch.zeros_like(z)
    x = x_pad.float()
    scale = 2.0 / pack.out_dim
    for _ in range(rec_iters):
        h = torch.relu(torch.matmul(z.to(bf), pack.w1).float() + pack.b1)
        t = torch.tanh(torch.matmul(h.to(bf), pack.d).float() + pack.bd)
        do = ((t - x) * (1.0 - t * t) * scale).to(bf)
        dh = torch.where(h > 0, torch.matmul(do, pack.dt).float(), 0.0)
        v = momentum * v + torch.matmul(dh.to(bf), pack.w1t).float()
        z = z - rec_lr * v
    return z


def library_loop_v2i(pack, x_pad, z0, *, rec_iters, rec_lr, momentum):
    """The v2i loop with torch._int_mm for the D products: yardstick."""
    import torch
    from defensegan_torch.kernels.fused_projection_v2i import _quant_rows
    base, bf = pack.base, torch.bfloat16
    z = z0.clone()
    v = torch.zeros_like(z)
    x = x_pad.float()
    scale = 2.0 / base.out_dim
    for _ in range(rec_iters):
        h = torch.relu(torch.matmul(z.to(bf), base.w1).float() + base.b1)
        hq, sh = _quant_rows(h)
        o = torch._int_mm(hq, pack.dq).float() * (sh * pack.sd) + base.bd
        t = torch.tanh(o)
        gq, sg = _quant_rows((t - x) * (1.0 - t * t) * scale)
        dh = torch._int_mm(gq, pack.dtq).float() * (sg * pack.sdt)
        dh = torch.where(h > 0, dh, 0.0).to(bf)
        v = momentum * v + torch.matmul(dh, base.w1t).float()
        z = z - rec_lr * v
    return z


def bounds(name: str, pack, n: int, iters: int) -> dict:
    """Least time for the loop at this shape: max(bytes / HBM rate,
    operations / peak rate per type). Inputs read once (weights, x, z0),
    output z written once. Counted at the function's true output width
    (784), not the kernel's padded P."""
    base = pack if name == "fused_projection_v2" else pack.base
    k, f = base.w1.shape
    p = base.out_dim
    z_bytes = 2 * n * k * 4 + n * p * 2          # z0 + z_final, bf16 x
    if name == "fused_projection_v2":
        w_bytes = 2 * k * f * 2 + 2 * f * p * 2 + (f + p) * 4
        t_ops = n * iters * 4 * (k * f + f * p) / PEAK_BF16
    else:
        w_bytes = 2 * k * f * 2 + 2 * f * p + 2 * (f + p) * 4 + f * 4
        t_ops = (n * iters * 4 * k * f / PEAK_BF16
                 + n * iters * 4 * f * p / PEAK_INT8)
    t_bytes = (w_bytes + z_bytes) / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU only",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "defensegan_torch")):
        print("chip_smoke: defensegan_torch/ not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.nn.functional as F

    from defensegan_torch.configs import load_config
    from defensegan_torch.defense.fastgen import (make_packed_apply,
                                                  pack_generator)
    from defensegan_torch.defense.pipeline import DefendedPipeline
    from defensegan_torch.defense.project import rec_losses, tile_restarts
    from defensegan_torch.eval.quality import (best_loss_p95, int8_gate_ok,
                                               tie_aware_disagreement)
    from defensegan_torch.gan import DefenseGAN
    from defensegan_torch.kernels import build
    from defensegan_torch.kernels.fused_projection_v2 import (
        dense_loop_plain, fused_projection_dense, pack_dense)
    from defensegan_torch.kernels.fused_projection_v2i import (
        dense_int8_loop_plain, fused_projection_dense_int8, pack_dense_int8)
    from defensegan_torch.models import build_classifier, from_image_space

    # fp32 references run in full float32 (no TF32 in products or convs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---------------------------------------------------------- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         build_s=round(time.perf_counter() - t0, 3))

    # ------------------------------------------------------------ 2. load
    cfg = load_config(RUN_DIR).replace(output_dir=RUN_DIR)
    gan = DefenseGAN(cfg).load()
    if gan.device.type != "cuda" or not gan.has_encoder():
        fail("flagship did not load on cuda with its encoder")
    k, rr, iters, lr, mom = (cfg.latent_dim, cfg.rec_rr, cfg.rec_iters,
                             cfg.rec_lr, cfg.rec_momentum)
    emit("load", step=gan.step, device=str(gan.device),
         dtype=str(gan.dtype), gen_arch=cfg.gen_arch, latent=k, rr=rr,
         iters=iters)

    g = torch.Generator(device=dev).manual_seed(1234)
    p2 = pack_dense(gan.generator)
    p8 = pack_dense_int8(gan.generator)
    p32 = pack_dense(gan.generator, torch.float32)
    apply_bf = make_packed_apply(pack_generator(gan.generator, "dense"))
    apply_32 = make_packed_apply(
        pack_generator(gan.generator, "dense", torch.float32))
    pdim = p2.d.shape[1]
    kernels = {
        "fused_projection_v2": dict(
            run=fused_projection_dense, plain=dense_loop_plain, pack=p2,
            library=library_loop_v2,
            source="defensegan_torch/csrc/fused_projection_v2.cu",
            replaces="defensegan_tpu/kernels/fused_projection_v2.py:85"),
        "fused_projection_v2i": dict(
            run=fused_projection_dense_int8, plain=dense_int8_loop_plain,
            pack=p8, library=library_loop_v2i,
            source="defensegan_torch/csrc/fused_projection_v2i.cu",
            replaces="defensegan_tpu/kernels/fused_projection_v2i.py:81"),
    }

    def x_pad_of(x_flat_tanh):
        return F.pad(x_flat_tanh.to(torch.bfloat16),
                     (0, pdim - x_flat_tanh.shape[1]))

    def images(n):
        """Clean requests G(z_true), [n, 28, 28, 1] in [0, 1]."""
        return gan.generate(g, n)

    def noisy(x):
        """Off-manifold copies: +-0.1 uniform noise, clipped to [0, 1]."""
        u = torch.rand(x.shape, device=dev, generator=g)
        return (x + (u - 0.5) * 0.2).clamp(0.0, 1.0)

    def rows(x_img, r):
        return tile_restarts(from_image_space(x_img).reshape(
            x_img.shape[0], -1), r)

    # ------------------------------------- 3a. elementwise, L = 1 and 5
    x_rows = rows(images(512), 1)
    z0 = torch.randn(512, k, device=dev, generator=g)
    errs = {name: {} for name in kernels}
    for steps, tol in ELEMENTWISE_TOL.items():
        for name, kk in kernels.items():
            zk = kk["run"](kk["pack"], x_rows, z0, rec_iters=steps,
                           rec_lr=lr, momentum=mom)
            zp = kk["plain"](kk["pack"], x_pad_of(x_rows), z0,
                             rec_iters=steps, rec_lr=lr, momentum=mom)
            # a row's result does not depend on the other rows: 192-row
            # chunks (192, 192, 128) must equal one chunk bit for bit
            zc = kk["run"](kk["pack"], x_rows, z0, rec_iters=steps,
                           rec_lr=lr, momentum=mom, chunk=192)
            torch.cuda.synchronize()
            err = (zk - zp).abs().max().item()
            moved = (zp - z0).abs().max().item()
            chunked_equal = bool(torch.equal(zc, zk))
            errs[name][steps] = err
            ok = bool(torch.isfinite(zk).all()) and err <= tol * moved \
                and chunked_equal
            emit(f"elementwise_{name}_L{steps}", max_abs_err=err,
                 moved=moved, rel=err / moved, tol_rel=tol,
                 chunked_equal=chunked_equal, ok=ok)
            if not ok:
                fail(f"{name} L={steps}: |dz| {err} > {tol} x {moved} or "
                     f"chunks differ ({chunked_equal})")

    # ------- 3b. L = 200, R = 10, 1024 images: 512 clean, 512 noisy
    b = 1024
    x_img = torch.cat([images(b // 2), noisy(images(b // 2))])
    x_rep = rows(x_img, rr)
    z0 = torch.randn(b * rr, k, device=dev, generator=g)

    def final_losses(z_fin, apply):
        return rec_losses(apply, z_fin, x_rep).reshape(b, rr).cpu().numpy()

    loop_kw = dict(rec_iters=iters, rec_lr=lr, momentum=mom)
    losses = {}
    for name, kk in kernels.items():
        losses[name] = final_losses(
            kk["run"](kk["pack"], x_rep, z0, **loop_kw), apply_bf)
        losses[name + "_plain"] = final_losses(
            kk["plain"](kk["pack"], x_pad_of(x_rep), z0, **loop_kw),
            apply_bf)
    losses["fp32"] = final_losses(
        dense_loop_plain(p32, F.pad(x_rep, (0, pdim - x_rep.shape[1])), z0,
                         **loop_kw), apply_32)
    gate = {}
    for name in kernels:
        ref, test = losses[name + "_plain"], losses[name]
        tie = tie_aware_disagreement(ref, test)
        p95 = best_loss_p95(ref, test)
        ok = tie["material_disagreement"] <= MATERIAL_MAX and p95 <= P95_MAX
        gate[name] = ok
        emit(f"selection_{name}_vs_plain", **tie, best_loss_p95=p95,
             material_max=MATERIAL_MAX, p95_max=P95_MAX, ok=ok)
    ref32, l8 = losses["fp32"], losses["fused_projection_v2i"]
    l16 = losses["fused_projection_v2"]
    t8, t16 = tie_aware_disagreement(ref32, l8), \
        tie_aware_disagreement(ref32, l16)
    p8_, p16 = best_loss_p95(ref32, l8), best_loss_p95(ref32, l16)
    with open(os.path.join(RUN_DIR, "checkpoints", "int8_gate.json")) as f:
        criterion = json.load(f)["criterion"]
    int8_ok = int8_gate_ok(t8["material_disagreement"],
                           t16["material_disagreement"], p8_, p16)
    emit("int8_gate_vs_fp32", material_int8=t8["material_disagreement"],
         material_bf16_control=t16["material_disagreement"],
         best_loss_p95_int8=p8_, best_loss_p95_bf16_control=p16,
         mean_best_loss_fp32_clean=float(ref32[:b // 2].min(1).mean()),
         mean_best_loss_fp32_noisy=float(ref32[b // 2:].min(1).mean()),
         criterion=criterion, ok=int8_ok)
    if not all(gate.values()) or not int8_ok:
        fail(f"selection gates: {gate}, int8 gate: {int8_ok}")

    # ---------------------------------------------------- 4. serving path
    clf = build_classifier("E", gen=torch.Generator().manual_seed(0)) \
        .to(dev).requires_grad_(False)
    x_cal = images(512)
    x_clean = images(256)
    x_req = torch.cat([x_clean, noisy(x_clean)])
    build.reset_launches()
    serving = {}
    for label, kw in (("auto", dict(rec_kernel="auto")),
                      ("pallas_int8", dict(rec_kernel="pallas_int8")),
                      ("encoder", dict(rec_kernel="auto",
                                       rec_init="encoder"))):
        pipe = DefendedPipeline(gan, clf, fpr=0.05, **kw)
        t0 = time.perf_counter()
        pipe.calibrate(x_cal)
        out = pipe.predict(x_req)
        torch.cuda.synchronize()
        clean_loss = float(out.rec_err[:256].mean())
        serving[label] = dict(
            path=gan.last_kernel, s=time.perf_counter() - t0,
            clean_mean_loss=clean_loss,
            noisy_mean_loss=float(out.rec_err[256:].mean()),
            flag_rate_clean=float(out.flagged[:256].mean()),
            flag_rate_noisy=float(out.flagged[256:].mean()),
            finite=bool(np.isfinite(out.rec_err).all()))
        if not serving[label]["finite"] or clean_loss > CLEAN_LOSS_MAX:
            fail(f"serving {label}: {serving[label]}")
    # a direct call at a batch the kernels' 64-row tile does not divide
    # (100 images x R 10 = 1000 rows) still runs the requested kernel
    for kernel in ("pallas", "pallas_int8"):
        res = gan.reconstruct(x_clean[:100], g, kernel=kernel)
        torch.cuda.synchronize()
        serving[f"direct_{kernel}"] = dict(
            path=gan.last_kernel, clean_mean_loss=float(res.loss.mean()),
            finite=bool(torch.isfinite(res.x_hat).all()),
            shape=list(res.x_hat.shape))
        if gan.last_kernel != kernel or not serving[f"direct_{kernel}"][
                "finite"] or float(res.loss.mean()) > CLEAN_LOSS_MAX or \
                res.x_hat.shape != x_clean[:100].shape:
            fail(f"direct {kernel}: {serving[f'direct_{kernel}']}")
    launches = dict(build.LAUNCHES)
    with torch.no_grad():
        unrelated = float(rec_losses(
            apply_bf, torch.randn(256, k, device=dev, generator=g),
            rows(x_clean, 1)).mean())
    emit("serving", **serving, launches=launches,
         clean_loss_max=CLEAN_LOSS_MAX, unrelated_latent_loss=unrelated)
    if serving["auto"]["path"] != "pallas" or \
            serving["pallas_int8"]["path"] != "pallas_int8":
        fail(f"dispatch: {serving}")
    if not all(launches[name] > 0 for name in kernels):
        fail(f"a kernel of the main path never launched: {launches}")

    # ------------------------------------------------------- 5. timing
    b = 1024
    n = b * rr
    x_img = images(b)
    x_rep = rows(x_img, rr)
    z0 = torch.randn(n, k, device=dev, generator=g)
    timing = {}
    for name, kk in kernels.items():
        pack = kk["pack"]
        xp = x_pad_of(x_rep)
        t = dict(
            ms=median_ms(lambda: kk["run"](pack, x_rep, z0, **loop_kw)),
            plain_ms=median_ms(lambda: kk["plain"](pack, xp, z0,
                                                   **loop_kw)),
            library_ms=median_ms(lambda: kk["library"](pack, xp, z0,
                                                       **loop_kw)),
            recon_ms=median_ms(lambda: gan.reconstruct(
                x_img, g, kernel="pallas" if name.endswith("v2")
                else "pallas_int8")))
        t["recon_per_s"] = b / (t["recon_ms"] / 1e3)
        t.update(bounds(name, pack, n, iters))
        timing[name] = t
    fp32_ms = median_ms(lambda: dense_loop_plain(
        p32, F.pad(x_rep, (0, pdim - x_rep.shape[1])), z0, **loop_kw))
    emit("timing", images=b, rr=rr, iters=iters, rows=n, **timing,
         fp32_plain_ms=fp32_ms, fp32_plain_recon_per_s=b / (fp32_ms / 1e3))

    # ------------------------------------------------- 6. kernels line
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": kk["source"],
         "replaces": kk["replaces"], "launches": launches[name],
         "max_abs_err": max(errs[name].values()),
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"],
         "bound_by": timing[name]["bound_by"],
         "library_ms": timing[name]["library_ms"]}
        for name, kk in kernels.items()]}
    RECORD["kernels"] = line
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(RECORD, f, indent=1)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
