"""Precision of the plain reference, and of its fp8 control.

The reference computes in float32 with TF32 off: on this GPU a float32
product may otherwise run in TF32 (cuBLAS when
`torch.backends.cuda.matmul.allow_tf32` is set, cuDNN by default).

The control is the same reference one precision step below what the
configurations state (bfloat16): every product's operands rounded to fp8
(e4m3, one scale per tensor, as an fp8 deployment scales them), sums in
float32. `FP8.operand` rounds a forward operand; `FP8.grad_operand`
rounds the gradient that a backward product takes as its operand.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """Round to e4m3 under one per-tensor scale (amax maps to 448)."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    q = torch.clamp(t.float() / scale, -E4M3_MAX, E4M3_MAX)
    return (q.to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


class _Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _GradOperand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


class Precision:
    """How the reference rounds the operands of its products."""

    def __init__(self, name: str, fp8: bool):
        self.name = name
        self.fp8 = fp8

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return _Operand.apply(t) if self.fp8 else t

    def grad_operand(self, t: torch.Tensor) -> torch.Tensor:
        return _GradOperand.apply(t) if self.fp8 else t


FP32 = Precision("float32", fp8=False)
FP8 = Precision("fp8_e4m3", fp8=True)


@contextlib.contextmanager
def float32_products():
    """TF32 off in cuBLAS and cuDNN for the block, restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
