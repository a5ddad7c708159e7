"""PyTorch port vs JAX: the helpers of utils/profiling.py (trace,
nan_guard) and defense/fastgen.py::unflatten."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defensegan_tpu.defense.fastgen import unflatten as jax_unflatten
from defensegan_torch.defense.fastgen import unflatten
from defensegan_torch.utils.profiling import nan_guard, trace


@pytest.mark.parametrize("shape", [(28, 28, 1), (64, 64, 3)])
def test_unflatten_equals_jax(shape):
    flat = np.random.RandomState(0).randn(5, int(np.prod(shape))).astype(
        np.float32)
    got = unflatten(torch.from_numpy(flat), shape)
    ref = np.asarray(jax_unflatten(jnp.asarray(flat), shape))
    assert tuple(got.shape) == ref.shape == (5,) + shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "traces"
    with trace(str(logdir)) as path:
        torch.relu(torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    assert path.startswith(str(logdir))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_nan_guard_raises_in_the_forward():
    with pytest.raises(FloatingPointError, match="log"):
        with nan_guard():
            torch.log(torch.tensor([1.0, -1.0]))
    with pytest.raises(FloatingPointError):
        with nan_guard():
            torch.tensor([1.0]) / torch.tensor([0.0])      # an infinity


def test_nan_guard_raises_in_the_backward():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="nan"):
        with nan_guard():
            (torch.sqrt(x) * 0.0).sum().backward()   # forward finite


def test_nan_guard_passes_finite_work_and_can_be_off():
    with nan_guard():
        x = torch.ones(4, requires_grad=True)
        (x * 2.0).sum().backward()
    assert torch.equal(x.grad, torch.full((4,), 2.0))
    with nan_guard(enable=False):
        assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()
    # the guard is gone after its scope
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()
