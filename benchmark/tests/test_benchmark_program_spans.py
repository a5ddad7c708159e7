"""The readers of the program's spans (benchmark/program_spans.py and the
six metrics over it), on a hand-made Chrome trace."""

import pytest

from benchmark import program_spans, spec, tracing
from benchmark.harness import RunRecord

METRICS = ("predict_idle_ms", "sync_idle_ms", "loop_device_ms")


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def span(name, ts, dur):
    return ev("user_annotation", name, ts, dur)


def launch(ts, corr, name="cudaLaunchKernel"):
    return ev("cuda_runtime", name, ts, 1, corr=corr)


def kernel(name, ts, dur, corr=None, cat="kernel"):
    return ev(cat, name, ts, dur, tid=7, corr=corr)


def request_one():
    """Request 10..135 us. Its loop (15..30) launches a fill and a copy
    (device 20..24), then the library's kernels, which carry no
    correlation id, run 24..60, 62..70 and 72..90; the selection's first
    op, launched at 35, starts at 90. Classifier 98..100; the sync span
    66..130 holds the loop's gap 70..72, a copy to the host (100..104)
    and an idle tail."""
    return [
        span(tracing.REQUEST, 5, 135),
        span("pipeline.predict", 10, 125),
        span("batching.chunk", 12, 48),
        span("gan.reconstruct", 13, 46),
        span("projection.loop", 15, 15),
        launch(16, 1), launch(18, 2, "cudaMemcpyAsync"),
        span("projection.select", 31, 9),
        launch(35, 3), launch(37, 4),
        span("pipeline.classify", 61, 4), launch(62, 5),
        span("pipeline.sync", 66, 64), launch(67, 6, "cudaMemcpyAsync"),
        span("pipeline.detect", 131, 3),
        kernel("fill", 20, 2, corr=1),
        kernel("Memcpy HtoD", 22, 2, corr=2, cat="gpu_memcpy"),
        kernel("gemm_sm90", 24, 36),
        kernel("gemm_sm90", 62, 8),
        kernel("gemm_sm90", 72, 18),
        kernel("select_losses", 90, 5, corr=3),
        kernel("argmin", 95, 3, corr=4),
        kernel("classifier", 98, 2, corr=5),
        kernel("Memcpy DtoH", 100, 4, corr=6, cat="gpu_memcpy"),
    ]


def request_two():
    """Request 155..285. Its loop (160..170) launches one fill (device
    172..174), the library runs 174..210 and 212..230; a host sync right
    after the loop (171) launches no device op, so the selection's op
    launched at 175 (230..240) ends the loop. Classifier 240..242; the
    sync span 206..280 holds the loop's gap 210..212 and a copy
    242..246."""
    return [
        span(tracing.REQUEST, 150, 140),
        span("pipeline.predict", 155, 130),
        span("batching.chunk", 157, 43),
        span("gan.reconstruct", 158, 41),
        span("projection.loop", 160, 10),
        launch(161, 11),
        launch(171, 13, "cudaStreamSynchronize"),
        span("projection.select", 175, 10), launch(175, 12),
        span("pipeline.classify", 201, 4), launch(202, 14),
        span("pipeline.sync", 206, 74), launch(207, 15, "cudaMemcpyAsync"),
        span("pipeline.detect", 281, 3),
        kernel("fill", 172, 2, corr=11),
        kernel("gemm_sm90", 174, 36),
        kernel("gemm_sm90", 212, 18),
        kernel("select_losses", 230, 10, corr=12),
        kernel("classifier", 240, 2, corr=14),
        kernel("Memcpy DtoH", 242, 4, corr=15, cat="gpu_memcpy"),
    ]


def trace_events():
    return ([span(tracing.WINDOW, 0, 300)] + request_one() + request_two()
            + [kernel("after the window", 350, 5)])


def record(events):
    reqs = [dict(n=1, rows=256, profiled=i in (1, 2), t_send=i * 0.05,
                 t_done=i * 0.05 + 0.02) for i in range(6)]
    return RunRecord(setup_s=9.5, image_flops=1_000_000, peak_bf16=1e12,
                     requests=reqs, trace=tracing.Trace(events))


def read(name, run):
    return spec.metric_reader(name)(run)


def test_each_request_by_hand():
    t = tracing.Trace(trace_events())
    # busy 20..60, 62..70 and 72..104 inside 10..135; 172..210 and
    # 212..246 inside 155..285
    assert program_spans.predict_idle(t) == [
        pytest.approx(45e-6), pytest.approx(58e-6)]
    # the syncs outside the loops' windows (20..90, 172..230): 90..130
    # is busy 90..104, 230..280 is busy 230..246; the loops' gaps 70..72
    # and 210..212 inside the syncs are not counted
    assert program_spans.sync_idle(t) == [
        pytest.approx(26e-6), pytest.approx(34e-6)]
    # loop 20..90 less the gaps 60..62 and 70..72; 172..230 less 210..212
    assert program_spans.loop_device(t) == [
        pytest.approx(66e-6), pytest.approx(56e-6)]


def test_a_slower_loop_leaves_the_sync_idle_as_it_was():
    # request one's library kernels 62..70 and 72..90 become 62..68 and
    # 74..90: two more idle us in the request, none in its syncs
    events = [dict(e, ts=74, dur=16) if e["name"] == "gemm_sm90"
              and e["ts"] == 72 else dict(e, dur=6)
              if e["name"] == "gemm_sm90" and e["ts"] == 62 else e
              for e in trace_events()]
    t = tracing.Trace(events)
    assert program_spans.predict_idle(t) == [
        pytest.approx(49e-6), pytest.approx(58e-6)]
    assert program_spans.sync_idle(t) == [
        pytest.approx(26e-6), pytest.approx(34e-6)]
    assert program_spans.loop_device(t) == [
        pytest.approx(62e-6), pytest.approx(56e-6)]


def test_the_library_kernels_count_by_their_place_in_the_stream():
    t = tracing.Trace(trace_events())
    # the ops the profiler ties to the loop spans cover 6 us of the 122
    assert t.range_device_s("projection.loop") == pytest.approx(6e-6)
    assert sum(program_spans.loop_device(t)) == pytest.approx(122e-6)


@pytest.mark.parametrize("cls", ["bulk", "serve"])
def test_the_six_metrics(cls):
    run = record(trace_events())
    got = {m: read(f"{m}.{cls}", run) for m in METRICS}
    assert got == {"predict_idle_ms": pytest.approx(51.5e-3),
                   "sync_idle_ms": pytest.approx(30e-3),
                   "loop_device_ms": pytest.approx(61e-3)}
    # idle inside the syncs is idle inside the request, and the loop's
    # device time and the request's idle time fit in the request
    request_ms = 1e-3 * min(b - a for a, b in
                            run.trace.ranges[tracing.REQUEST])
    assert got["sync_idle_ms"] <= got["predict_idle_ms"]
    assert got["loop_device_ms"] + got["predict_idle_ms"] <= request_ms


def without(*names):
    return [e for e in trace_events() if e["name"] not in names]


@pytest.mark.parametrize("cls", ["bulk", "serve"])
def test_none_without_the_spans(cls):
    # the parent program's trace: the benchmark's ranges, no program spans
    bare = record(without("pipeline.predict", "batching.chunk",
                          "gan.reconstruct", "projection.loop",
                          "projection.select", "pipeline.classify",
                          "pipeline.sync", "pipeline.detect"))
    assert all(read(f"{m}.{cls}", bare) is None for m in METRICS)
    no_kids = record(without("pipeline.sync", "projection.loop"))
    assert read(f"predict_idle_ms.{cls}", no_kids) == pytest.approx(51.5e-3)
    assert read(f"sync_idle_ms.{cls}", no_kids) is None
    assert read(f"loop_device_ms.{cls}", no_kids) is None
    run = record(trace_events())
    run.trace = None
    assert all(read(f"{m}.{cls}", run) is None for m in METRICS)


def test_a_loop_with_no_tied_op_counts_from_its_start():
    # request two's fill and its launch gone: its loop counts from 160,
    # busy 174..210 and 212..230
    events = [e for e in trace_events()
              if (e.get("args") or {}).get("correlation") != 11]
    assert program_spans.loop_device(tracing.Trace(events)) == [
        pytest.approx(66e-6), pytest.approx(54e-6)]
