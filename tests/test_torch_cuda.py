"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip without an NVIDIA GPU (the kernels build with
nvcc at first use). This file imports neither JAX nor the JAX package, so
it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py sets JAX up for the CPU suite.) The
widths here (latent 32; wide F 1568; deep c0 8, ca 16) exercise the
wrappers' padding of k, F and the deep loop's channels to the kernels'
64-wide tiles; chip_smoke.py checks the full widths.
Tolerances are chip_smoke.py's elementwise bounds: kernel and plain
version differ only in float32 summation order, which flips a bf16
rounding (2^-8 relative) of an intermediate now and then, carried forward
by the lr = 10 momentum steps.
"""

import numpy as np
import pytest
import torch

from defensegan_torch.kernels import build
from defensegan_torch.kernels.fused_projection_v2 import (
    dense_loop_plain, fused_projection_dense, pack_dense, pad_targets)
from defensegan_torch.kernels.fused_projection_v2i import (
    dense_int8_loop_plain, fused_projection_dense_int8, pack_dense_int8)
from defensegan_torch.kernels.fused_projection_v3 import (
    fused_projection_s2d, pack_s2d, s2d_loop_plain)
from defensegan_torch.models.generator import generator_for

LR, MOM = 10.0, 0.7
TOL = {1: 4e-3, 5: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc)")
    return torch.device("cuda")


def _case(dev, n=128, arch="wide"):
    tg = generator_for("mnist", 4, torch.bfloat16, arch, 32,
                       gen=torch.Generator().manual_seed(0))
    tg = tg.to(dev).requires_grad_(False)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(np.tanh(rng.randn(n, 784)).astype(np.float32))
    z0 = torch.from_numpy(rng.randn(n, 32).astype(np.float32))
    return tg, x.to(dev), z0.to(dev)


def _kernel(name, tg):
    """(pack, wrapper, plain version, bf16 base pack) of a kernel."""
    if name == "fused_projection_v3":
        return pack_s2d(tg), fused_projection_s2d, s2d_loop_plain, None
    if name == "fused_projection_v2":
        pack = pack_dense(tg)
        return pack, fused_projection_dense, dense_loop_plain, pack
    pack = pack_dense_int8(tg)
    return (pack, fused_projection_dense_int8, dense_int8_loop_plain,
            pack.base)


KERNELS = ["fused_projection_v2", "fused_projection_v2i",
           "fused_projection_v3"]


def _arch(name):
    return "deep" if name == "fused_projection_v3" else "wide"


def _targets(base, x):
    """The plain version's x: v2 / v2i pad it to P; v3 takes it as is."""
    return x if base is None else pad_targets(base, x, x.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("name", KERNELS)
def test_kernel_matches_plain(cuda_device, name, steps):
    tg, x, z0 = _case(cuda_device, arch=_arch(name))
    pack, run, plain, base = _kernel(name, tg)
    before = build.LAUNCHES[name]
    got = run(pack, x, z0, rec_iters=steps, rec_lr=LR, momentum=MOM,
              chunk=64)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 2     # two 64-row chunks
    ref = plain(pack, _targets(base, x), z0, rec_iters=steps, rec_lr=LR,
                momentum=MOM)
    moved = (ref - z0).abs().max().item()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= TOL[steps] * moved


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNELS)
def test_kernel_pads_rows_and_chunks_exactly(cuda_device, name):
    """200 rows (not a multiple of the 64-row tile) are padded and
    cropped; a row's result does not depend on the other rows, so 64-row
    chunks (the last one short after padding) equal one chunk bit for
    bit, and both match the plain version."""
    tg, x, z0 = _case(cuda_device, n=200, arch=_arch(name))
    pack, run, plain, base = _kernel(name, tg)
    kw = dict(rec_iters=5, rec_lr=LR, momentum=MOM)
    before = build.LAUNCHES[name]
    one = run(pack, x, z0, **kw)
    chunked = run(pack, x, z0, chunk=64, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 1 + 4   # 256 padded rows
    assert one.shape == (200, 32) and torch.equal(one, chunked)
    ref = plain(pack, _targets(base, x), z0, **kw)
    moved = (ref - z0).abs().max().item()
    assert (one - ref).abs().max().item() <= TOL[5] * moved


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    tg, x, z0 = _case(cuda_device)
    with pytest.raises(ValueError, match="multiple of 64"):
        fused_projection_dense(pack_dense(tg), x, z0, rec_iters=1,
                               rec_lr=LR, momentum=MOM, chunk=100)
    cpu_pack = pack_dense(tg.to("cpu"))
    with pytest.raises(ValueError, match="one device"):
        fused_projection_dense(cpu_pack, x[:64], z0[:64], rec_iters=1,
                               rec_lr=LR, momentum=MOM)
