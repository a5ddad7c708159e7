"""Fused projection v2i: the v2 loop with both D products in int8.

Port of the JAX package's kernels/fused_projection_v2i.py. The two D
products (h @ D and do @ D^T, F x P) are ~87% of a step's operations; here they run
int8 x int8 -> int32:

  - D / D^T are quantized per COLUMN to int8 once at pack time (symmetric,
    scale = colmax|.| / 127; all-zero padded columns get scale 1);
  - h (>= 0) and the tanh-gradient signal do are quantized per ROW at
    every step from their float32 values (scale = max(rowmax, 1e-30) /
    127, round half to even, clip to +-127);
  - the int32 result is dequantized by the rank-1 product of the row and
    column scales.

The CUDA kernel runs both D products on Hopper's s8 wgmma, which reads its
B operand only K-major: the pack also carries the codes transposed, Dq^T
[P, F] and DTq^T [F, P] (`dq_k`, `dtq_k`: the same values, nothing
re-quantized). The row amax of h and of do is taken in the epilogue that
produces them, so the quantize pass reads each float32 row once.

The z-side products (z @ W1, dh @ W1^T) stay bf16. Restart selection and
G(z*) run outside the loop exactly as for v2. Whether int8 keeps defense
quality is gated per checkpoint (output/gans/<run>/checkpoints/
int8_gate.json holds the criterion); `pallas_int8` is therefore opt-in.

`fused_projection_dense_int8` runs the loop through csrc/
fused_projection_v2i.cu on a CUDA tensor and through `dense_int8_loop_plain`
on a CPU tensor. The plain version sums the int8 products exactly (in
float64: a sum of 6272 products of +-127 reaches ~1e8, past float32's
exact integers) and rounds the sum to float32 as the kernel's int32 ->
float conversion does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from defensegan_torch.kernels.fused_projection_v2 import (
    DensePack, make_dense_reconstructor, pack_dense, pad_targets, padded_fc,
    rounding)
from defensegan_torch.kernels.gemm import split_k_for
from defensegan_torch.kernels.loop import COL_TILE, LoopState, pad_to, \
    run_loop
from defensegan_torch.utils.profiling import span


class DensePackInt8(NamedTuple):
    base: DensePack
    dq: torch.Tensor    # [F, P] int8, D quantized per column
    sd: torch.Tensor    # [1, P] f32 column scales of D
    dtq: torch.Tensor   # [P, F] int8, D^T quantized per column
    sdt: torch.Tensor   # [1, F] f32 column scales of D^T
    dq_k: torch.Tensor   # [P, F] int8, dq transposed (K-major for h @ Dq)
    dtq_k: torch.Tensor  # [F, P] int8, dtq transposed (for do @ DTq)


def _quant_cols(w: np.ndarray):
    """Symmetric per-column int8: returns (q [., C] int8, s [C] f32)."""
    amax = np.abs(w).max(axis=0)
    s = np.where(amax > 0, amax / 127.0, 1.0)  # zero cols: q=0, scale=1
    q = np.clip(np.rint(w / s), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def pack_dense_int8(generator) -> DensePackInt8:
    base = pack_dense(generator)
    dev = base.d.device
    d = base.d.float().cpu().numpy()
    dt = base.dt.float().cpu().numpy()
    dq, sd = _quant_cols(d)
    dtq, sdt = _quant_cols(dt)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    return DensePackInt8(base=base, dq=t(dq), sd=t(sd[None, :]),
                         dtq=t(dtq), sdt=t(sdt[None, :]), dq_k=t(dq.T),
                         dtq_k=t(dtq.T))


def _quant_rows(a: torch.Tensor, amax_guard: float = 1e-30):
    """Symmetric per-row int8 of a f32 array: (q int8, s [T, 1] f32)."""
    amax = torch.amax(torch.abs(a), dim=1, keepdim=True)
    s = torch.clamp_min(amax, amax_guard) / 127.0
    q = torch.clamp(torch.round(a / s), -127.0, 127.0).to(torch.int8)
    return q, s


def _int_mm(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 product, rounded once to float32."""
    return (q.double() @ w.double()).float()


def dense_int8_loop_plain(pack: DensePackInt8, x_pad: torch.Tensor,
                          z0: torch.Tensor, *, rec_iters: int,
                          rec_lr: float, momentum: float) -> torch.Tensor:
    """Plain PyTorch version of the v2i loop; returns z_final [N, k]."""
    base = pack.base
    rnd = rounding(base)
    w1, w1t = base.w1.float(), base.w1t.float()
    x = x_pad.float()
    scale = 2.0 / base.out_dim
    z = z0.float().clone()
    v = torch.zeros_like(z)
    for _ in range(rec_iters):
        h = torch.relu(rnd(z) @ w1 + base.b1)
        hq, sh = _quant_rows(h)
        t = torch.tanh(_int_mm(hq, pack.dq) * (sh * pack.sd) + base.bd)
        do = (t - x) * (1.0 - t * t) * scale
        gq, sg = _quant_rows(do)
        dh = _int_mm(gq, pack.dtq) * (sg * pack.sdt)
        dh = rnd(torch.where(h > 0.0, dh, 0.0))
        v = momentum * v + dh @ w1t
        z = z - rec_lr * v
    return z


def dense_int8_state(pack: DensePackInt8) -> LoopState:
    """fp_v2i_run's state: v2's fc, the int8 codes and column scales of D
    and D^T (F up to a multiple of 64, unit scales on the padded D^T
    columns, as _quant_cols gives all-zero columns), bD."""
    base = pack.base
    w1, w1t, b1 = padded_fc(base)
    kp, fp = w1.shape
    p = base.d.shape[1]
    splits = split_k_for(fp, kp)          # the fc backward dh @ W1^T
    f32, i8, i32 = torch.float32, torch.int8, torch.int32
    return LoopState(
        library="fused_projection_v2i", entry="fp_v2i_run",
        weights=(w1, w1t, b1, pad_to(pack.dq_k, 1, COL_TILE), pack.sd,
                 pad_to(pack.dtq_k, 0, COL_TILE),
                 pad_to(pack.sdt, 1, COL_TILE, 1.0), base.bd),
        scratch=((kp, torch.bfloat16), (fp, f32), (fp, i8), (1, f32),
                 (p, f32), (p, i8), (1, f32), (fp, torch.bfloat16),
                 (1, i32), (1, i32), (splits * kp, f32)),
        dims=(kp, fp, p, splits), out_dim=base.out_dim)


def fused_projection_dense_int8(pack: DensePackInt8,
                                x_flat_tanh: torch.Tensor,
                                z0_flat: torch.Tensor, *, rec_iters: int,
                                rec_lr: float, momentum: float,
                                chunk: Optional[int] = None,
                                state: Optional[LoopState] = None
                                ) -> torch.Tensor:
    """Run the int8 L-step loop for all N latents; returns z_final [N, k].

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on `state` (`dense_int8_state(pack)` when None) or raises.
    """
    x_pad = pad_targets(pack.base, x_flat_tanh, z0_flat.shape[0])
    if z0_flat.device.type == "cpu":
        with span("projection.loop"):
            return dense_int8_loop_plain(pack, x_pad, z0_flat,
                                         rec_iters=rec_iters, rec_lr=rec_lr,
                                         momentum=momentum)
    return run_loop(state or dense_int8_state(pack), x_pad, z0_flat,
                    rec_iters=rec_iters, rec_lr=rec_lr, momentum=momentum,
                    chunk=chunk)


def make_dense_int8_reconstructor(generator, image_shape, *, rec_rr: int,
                                  rec_iters: int, rec_lr: float,
                                  momentum: float):
    """f(x, gen=None, z0=None) -> ReconstructionResult on the int8 loop,
    its state built here once; v2's epilogue."""
    pack = pack_dense_int8(generator)
    return make_dense_reconstructor(
        generator, image_shape, rec_rr=rec_rr, rec_iters=rec_iters,
        rec_lr=rec_lr, momentum=momentum, pack=pack,
        loop=functools.partial(fused_projection_dense_int8,
                               state=dense_int8_state(pack)))
