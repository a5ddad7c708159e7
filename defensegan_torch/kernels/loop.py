"""The library loop under every fused loop (v2, v2i, v3, v4, the v3 layout
experiments): `run_loop` runs all L steps of a row chunk in one call into
the loop's CUDA library, on a `LoopState` that each reconstructor builds
once (so a request pads no weight and uploads no host table), and
`make_loop_reconstructor` is the reconstructor every loop shares."""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from defensegan_torch.defense.project import (ReconstructionResult,
                                              rec_losses, sample_z0,
                                              select_restarts,
                                              tile_restarts)
from defensegan_torch.kernels import build
from defensegan_torch.models.generator import from_image_space
from defensegan_torch.utils.profiling import span

ROW_TILE = 64        # rows are padded to, and chunks cut at, multiples of
                     # this (the kernels themselves take any row count)
COL_TILE = 64        # the kernels' widths are multiples of this (a GEMM
                     # epilogue's warp covers 64 columns of a row)
SCRATCH_CAP = 1 << 30  # bytes of per-row scratch in one call
ONE_TILE_COUNTER = "conv3x3_one_tile"   # build.LAUNCHES key of the calls
                     # whose grid convs ran as one 64-row tile


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_to(t: torch.Tensor, dim: int, mult: int, value: float = 0.0):
    """Zero-pad (or `value`-pad) dim of t up to a multiple of mult."""
    extra = round_up(t.shape[dim], mult) - t.shape[dim]
    if not extra:
        return t
    pads = [0, 0] * (t.ndim - dim - 1) + [0, extra]
    return F.pad(t, pads, value=value).contiguous()


class LoopState(NamedTuple):
    """What a library call takes besides its rows, for one pack on one
    device. Every entry takes (z, v, x, *weights, *scratch, M, *dims,
    iters, lr, momentum, scale, stream)."""

    library: str          # the kernel's library (build.KERNELS)
    entry: str            # the C entry point in it
    weights: tuple        # padded pack tensors, W1 [kp, .] first, and host
                          # tables (ctypes arrays of pointers or widths)
    scratch: tuple        # (columns, dtype) of each per-row buffer
    dims: tuple           # the kernel's widths, kp first
    out_dim: int          # the loss's mean: the step's scale is 2/out_dim
    counter: Optional[str] = None   # build.LAUNCHES key, else the library
    keep: tuple = ()      # tensors a host table points into, kept alive


def default_chunk(scratch) -> int:
    """Rows a call: the whole ROW_TILEs whose scratch fits SCRATCH_CAP."""
    row_bytes = sum(cols * dt.itemsize for cols, dt in scratch)
    return max(ROW_TILE, SCRATCH_CAP // row_bytes // ROW_TILE * ROW_TILE)


def argtypes(state: LoopState) -> list:
    """The entry's ctypes parameters, in LoopState's order."""
    pointers = 3 + len(state.weights) + len(state.scratch)
    return [ctypes.c_void_p] * pointers + \
        [ctypes.c_int] * (2 + len(state.dims)) + [ctypes.c_float] * 3 + \
        [ctypes.c_void_p]


def _entry(lib: ctypes.CDLL, state: LoopState):
    """The entry, bound once: ctypes keeps one function object a name."""
    fn = getattr(lib, state.entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes(state)
        fn.restype = ctypes.c_int
    return fn


def run_loop(state: LoopState, x_pad: torch.Tensor, z0_flat: torch.Tensor,
             *, rec_iters: int, rec_lr: float, momentum: float,
             chunk: Optional[int] = None) -> torch.Tensor:
    """Drive a fused loop's library on CUDA tensors; z_final [N, k].

    x_pad: the targets in the kernel's layout, [N, .]; z0_flat: [N, k]
    float32. Rows are zero-padded up to a multiple of ROW_TILE and cropped
    after. They run in chunks of `chunk` rows (`default_chunk` when None),
    one library call (all L steps) each, counted in build.LAUNCHES (and
    under ONE_TILE_COUNTER where the library reports that its grid convs
    took the one-tile form).
    Under a torch.profiler the fills, the targets' row padding and the
    library calls are a projection.loop span.
    """
    dev = z0_flat.device
    if dev.type != "cuda":
        raise ValueError(f"the fused kernel runs on CUDA tensors, got {dev}")
    w1 = state.weights[0]
    tensors = [t for t in state.weights if isinstance(t, torch.Tensor)]
    if any(t.device != dev or not t.is_contiguous() for t in tensors) or \
            x_pad.device != dev:
        raise ValueError(f"pack on {w1.device}, x on {x_pad.device}, z0 on "
                         f"{dev}: one device, the pack contiguous")
    if w1.dtype != torch.bfloat16:
        raise ValueError("the fused kernel takes a bf16 pack")
    n, k = z0_flat.shape
    rows = round_up(n, ROW_TILE)
    if chunk is None:
        chunk = default_chunk(state.scratch)
    if chunk % ROW_TILE:
        raise ValueError(f"chunk={chunk} must be a multiple of {ROW_TILE}")
    m = min(chunk, rows)
    with span("projection.loop"):
        z = torch.zeros((rows, w1.shape[0]), dtype=torch.float32, device=dev)
        z[:n, :k] = z0_flat
        v = torch.zeros_like(z)
        x = pad_to(x_pad, 0, ROW_TILE).contiguous()
        bufs = [torch.empty((m, cols), dtype=dt, device=dev)
                for cols, dt in state.scratch]
        ptrs = [t.data_ptr() if isinstance(t, torch.Tensor) else t
                for t in state.weights] + [t.data_ptr() for t in bufs]
        lib = build.load(state.library)
        fn = _entry(lib, state)
        # the library's host code (kernel attributes, SM count, the
        # launch) uses the runtime's current device: make it the tensors'
        # device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for lo in range(0, rows, m):
                tiles = build.one_tile_launches(lib)
                rc = fn(z[lo].data_ptr(), v[lo].data_ptr(),
                        x[lo].data_ptr(), *ptrs, min(m, rows - lo),
                        *state.dims, rec_iters, rec_lr, momentum,
                        2.0 / state.out_dim, stream)
                build.check(lib, rc, state.entry)
                build.LAUNCHES[state.counter or state.library] += 1
                if build.one_tile_launches(lib) > tiles:
                    build.LAUNCHES[ONE_TILE_COUNTER] += 1
        return z[:n, :k]


def make_loop_reconstructor(loop: Callable, apply_flat: Callable,
                            stage: Callable, image_shape, *, rec_rr: int,
                            z_dim: int, unstage: Optional[Callable] = None):
    """f(x, gen=None, z0=None) -> ReconstructionResult on `loop`
    (targets, z0_flat) -> z_final; z0 [B, R, k] overrides sampling from
    the torch.Generator `gen`. stage(x_tanh) -> [B, .] targets of the loop
    and of the selection (None: the loop's). Restart selection and G(z*)
    run outside the loop on apply_flat, in the selection targets' order
    (argmin semantics of defense/project.py); unstage maps x_hat back to
    image order."""
    @torch.no_grad()
    def run(x: torch.Tensor, gen: Optional[torch.Generator] = None,
            z0: Optional[torch.Tensor] = None) -> ReconstructionResult:
        batch = x.shape[0]
        if z0 is None:
            z0 = sample_z0(gen, batch, rec_rr, z_dim, device=x.device)
        with span("projection.stage"):
            targets, select_targets = stage(from_image_space(x))
            targets = tile_restarts(targets, rec_rr)
            select_targets = targets if select_targets is None else \
                tile_restarts(select_targets, rec_rr)
        z_fin = loop(targets, z0.reshape(batch * rec_rr, z_dim))
        with span("projection.select"):
            losses = rec_losses(apply_flat, z_fin, select_targets).reshape(
                batch, rec_rr)
            res = select_restarts(losses, z_fin, apply_flat)
            x_hat = res.x_hat if unstage is None else unstage(res.x_hat)
            return res._replace(x_hat=x_hat.reshape(
                (batch,) + tuple(image_shape)))

    return run
