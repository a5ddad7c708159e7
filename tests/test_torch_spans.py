"""The request path's spans (utils/profiling.py::span): recorded into a
torch.profiler's trace as nested ranges, and never built while no
profiler records."""

import json

import numpy as np
import pytest
import torch

from defensegan_torch.configs import Config
from defensegan_torch.defense.pipeline import DefendedPipeline
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.kernels.fused_projection_v2 import (
    fused_projection_dense, pack_dense)
from defensegan_torch.models import build_classifier
from defensegan_torch.utils import profiling

torch.set_num_threads(2)

LATENT, RR, ITERS, BATCH = 16, 2, 3, 4

# each span and the span that directly encloses it on a request
PARENT = {"pipeline.predict": None,
          "batching.chunk": "pipeline.predict",
          "gan.reconstruct": "batching.chunk",
          "projection.loop": "gan.reconstruct",
          "projection.select": "gan.reconstruct",
          "pipeline.classify": "pipeline.predict",
          "pipeline.sync": "pipeline.predict",
          "pipeline.detect": "pipeline.predict"}


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    """A calibrated pipeline on a tiny wide generator (plain path, CPU)."""
    cfg = Config(type="mnist", gen_arch="wide", gen_dim=4, disc_dim=4,
                 latent_dim=LATENT, rec_rr=RR, rec_iters=ITERS,
                 compute_dtype="float32",
                 output_dir=str(tmp_path_factory.mktemp("run")))
    gan = DefenseGAN(cfg, device="cpu")
    clf = build_classifier("E").requires_grad_(False)
    p = DefendedPipeline(gan, clf)
    x = np.random.RandomState(0).rand(8, 28, 28, 1).astype(np.float32)
    return p.calibrate(x, batch_size=BATCH)


def ranges(prof, tmp_path):
    """The profile's user ranges as (name, start, end), by start."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"),
                  key=lambda r: (r[1], -r[2]))


def innermost_parent(span, spans):
    """The shortest other span that contains `span`, or None."""
    _, a, b = span
    around = [s for s in spans if s is not span and s[1] <= a and b <= s[2]]
    return min(around, key=lambda s: s[2] - s[1], default=None)


def test_predict_records_the_nested_spans(pipe, tmp_path):
    x = np.random.RandomState(1).rand(6, 28, 28, 1).astype(np.float32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = pipe.predict(x, batch_size=BATCH)       # chunks of 4 and 2
    assert out.pred.shape == (6,)
    spans = [s for s in ranges(prof, tmp_path) if s[0] in PARENT]
    counts = {name: sum(s[0] == name for s in spans) for name in PARENT}
    assert counts == {"pipeline.predict": 1, "batching.chunk": 2,
                      "gan.reconstruct": 2, "projection.loop": 2,
                      "projection.select": 2, "pipeline.classify": 2,
                      "pipeline.sync": 2, "pipeline.detect": 1}
    for s in spans:
        parent = innermost_parent(s, spans)
        assert (parent[0] if parent else None) == PARENT[s[0]], s
    # the caller's work on a chunk lies outside the chunk's span
    for chunk in (s for s in spans if s[0] == "batching.chunk"):
        for other in spans:
            if other[0] in ("pipeline.classify", "pipeline.sync"):
                assert other[1] >= chunk[2] or other[2] <= chunk[1]


def test_no_record_function_without_a_profiler(pipe, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no "
                             "profiler recording")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    x = np.random.RandomState(2).rand(5, 28, 28, 1).astype(np.float32)
    assert pipe.predict(x, batch_size=BATCH).pred.shape == (5,)
    assert profiling.span("pipeline.predict") is \
        profiling.span("pipeline.sync")


def test_span_is_a_profiler_range_only_while_one_records(tmp_path):
    assert not isinstance(profiling.span("a"),
                          torch.profiler.record_function)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("outer.span"):
            with profiling.span("inner.span"):
                torch.ones(3).add_(1)
    got = ranges(prof, tmp_path)
    names = [r[0] for r in got]
    assert names.index("outer.span") < names.index("inner.span")
    outer, inner = (next(r for r in got if r[0] == n)
                    for n in ("outer.span", "inner.span"))
    assert outer[1] <= inner[1] and inner[2] <= outer[2]


def test_dense_loop_on_cpu_records_its_span(pipe, tmp_path):
    pack = pack_dense(pipe.gan.generator, dtype=torch.float32)
    n = 6
    x = torch.tanh(torch.randn(n, pack.out_dim))
    z0 = torch.randn(n, pack.z_dim)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        z = fused_projection_dense(pack, x, z0, rec_iters=2, rec_lr=0.5,
                                   momentum=0.7)
    assert z.shape == (n, pack.z_dim)
    assert [r[0] for r in ranges(prof, tmp_path)
            if r[0].startswith("projection.")] == ["projection.loop"]


class _Profile:
    """What a CUDA profile of one call holds when a span launched one
    kernel: the span's host row (its kernel under it), the kernel's row,
    and the device-side row the profiler makes of the span (a user
    annotation as long as the span, on the device)."""

    def __init__(self, span_us=12.0, kernel_us=10.0):
        from torch.autograd import DeviceType
        from torch.autograd.profiler_util import EventList, FunctionEvent

        def event(i, name, us, device, annotation):
            return FunctionEvent(
                id=i, name=name, thread=0, start_us=0, end_us=us,
                device_type=device, is_user_annotation=annotation,
                stack=[], input_shapes=[], use_device="cuda")
        host = event(1, "projection.loop", span_us + 3, DeviceType.CPU, True)
        host.append_kernel("gemm_sm90", 0, kernel_us)
        self.events = EventList(
            [host, event(2, "gemm_sm90", kernel_us, DeviceType.CUDA, False),
             event(3, "projection.loop", span_us, DeviceType.CUDA, True)],
            use_device="cuda")
        self.events._build_tree()

    def key_averages(self):
        return self.events.key_averages()


def test_device_rows_count_each_kernel_once(tmp_path):
    # the span's device-side row is not a kernel: one kernel, its 10 us
    assert profiling.device_rows(_Profile()) == [("gemm_sm90", 10.0, 1)]
    # a CPU profile of a call that opens a span holds no device work
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("projection.loop"):
            torch.ones(3).add_(1)
    assert profiling.device_rows(prof) == []


def test_v4_stages_its_targets_in_a_span_of_their_own(tmp_path,
                                                      monkeypatch):
    """A 64x64 stack through DefenseGAN.reconstruct on the v4 path (the
    resolver asked for CUDA; on CPU tensors the reconstructor runs the
    plain loop): gan.reconstruct holds projection.stage (the targets in
    tanh space, blocked order, restarts tiled), then projection.loop, then
    projection.select, one after the other."""
    from defensegan_torch.gan import defense_gan
    real = defense_gan._resolve
    monkeypatch.setattr(defense_gan, "_resolve",
                        lambda gan, **kw: real(gan, on_cuda=True, **kw))
    gan = DefenseGAN(Config(type="celeba", gen_arch="deep", gen_dim=2,
                            latent_dim=8, image_size=64, channels=3,
                            rec_rr=RR, rec_iters=ITERS,
                            compute_dtype="float32",
                            output_dir=str(tmp_path)), device="cpu")
    x = torch.rand(3, 64, 64, 3, generator=torch.Generator().manual_seed(3))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = gan.reconstruct(x, z0=torch.randn(3, RR, 8))
    assert gan.last_kernel == "pallas_v4" and res.x_hat.shape == x.shape
    names = ("gan.reconstruct", "projection.stage", "projection.loop",
             "projection.select")
    spans = [s for s in ranges(prof, tmp_path) if s[0] in names]
    assert [s[0] for s in spans] == list(names)
    for s in spans[1:]:
        assert innermost_parent(s, spans)[0] == "gan.reconstruct", s
    for before, after in zip(spans[1:], spans[2:]):
        assert before[2] <= after[1], (before, after)
