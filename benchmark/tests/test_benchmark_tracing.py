"""The traced run's reduction, on a hand-made Chrome trace, and the
per-layer metrics' arithmetic on a hand-made run record."""

import pytest

from benchmark import spec, tracing
from benchmark.harness import RunRecord


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def trace_events():
    """Window 0..100 us, one request 5..95; its reconstruct range 10..30
    on the host
    launches two correlated kernels (a torch op at 12, another at 28) with
    a library's uncorrelated kernels between them on the device; then a
    host sync 60..90 with a copy on the device."""
    return [
        ev("user_annotation", tracing.WINDOW, 0, 100),
        ev("user_annotation", tracing.REQUEST, 5, 90),
        ev("user_annotation", tracing.RECONSTRUCT, 10, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 28, 1, corr=2),
        ev("cpu_op", "aten::to", 60, 30),
        ev("kernel", "tile_restarts", 15, 5, tid=7, corr=1),
        ev("kernel", "fp_v2_gemm", 20, 20, tid=7),
        ev("kernel", "fp_v2_gemm", 45, 10, tid=7),
        ev("kernel", "select_restarts", 55, 5, tid=7, corr=2),
        ev("gpu_memcpy", "Memcpy DtoH", 80, 5, tid=7, corr=9),
        ev("kernel", "after the window", 150, 5, tid=7),
    ]


def test_busy_window_and_counts():
    t = tracing.Trace(trace_events())
    assert t.window_s == pytest.approx(100e-6)
    # union of 15-40, 45-60, 80-85
    assert t.busy_s == pytest.approx(45e-6)
    assert t.kernel_count() == 4


def test_range_device_time_covers_uncorrelated_kernels():
    t = tracing.Trace(trace_events())
    # from the first correlated kernel (15) to the end of the last (60)
    assert t.range_device_s(tracing.RECONSTRUCT) == pytest.approx(40e-6)
    assert t.range_device_s("no.such.range") is None
    # the request less the reconstruct call up to its device work's end
    assert t.self_s(tracing.REQUEST, tracing.RECONSTRUCT) == \
        [pytest.approx(40e-6)]


def test_breakdown():
    t = tracing.Trace(trace_events())
    assert t.top_ops()[0] == ["fp_v2_gemm", pytest.approx(30e-6)]
    gaps = dict((k, v) for k, v in t.idle_gaps())
    # 0-15: the window then the request; 40-45 after the reconstruct
    # range: the request; 60-80 during the host's aten::to (60-90);
    # 85-100: mid-gap 92.5 is in the request
    assert gaps["aten::to"] == pytest.approx(20e-6)
    assert gaps[tracing.REQUEST] == pytest.approx(35e-6)
    assert sum(gaps.values()) == pytest.approx(55e-6)


def test_one_window_only():
    with pytest.raises(ValueError):
        tracing.Trace(trace_events() + [ev("user_annotation",
                                           tracing.WINDOW, 200, 5)])


def record(trace=None):
    reqs = [dict(n=1, rows=256, profiled=False,
                 t_send=i * 0.05, t_done=i * 0.05 + 0.025 + 0.001 * i)
            for i in range(20)]
    reqs[1]["profiled"] = True
    return RunRecord(setup_s=9.5,
                     image_flops=1_000_000, peak_bf16=1e12,
                     requests=reqs, trace=trace)


def read(name, run):
    return spec.metric_reader(name)(run)


def test_end_to_end_readers():
    run = record()
    assert read("setup_s", run) == 9.5
    lat = sorted((r["t_done"] - r["t_send"]) * 1e3 for r in run.requests)
    assert read("latency_p50_ms", run) == pytest.approx(
        (lat[9] + lat[10]) / 2)
    assert lat[18] <= read("latency_p95_ms", run) <= lat[19]
    assert read("defended_images_per_s", run) == pytest.approx(
        20 / (19 * 0.05 + 0.025 + 0.019))


def test_per_layer_readers():
    t = tracing.Trace(trace_events())
    run = record(t)
    assert read("useful_rows_pct.serve", run) == pytest.approx(100 / 256)
    assert read("kernels_per_request.serve", run) == 4
    assert read("device_idle_pct.serve", run) == pytest.approx(55.0)
    assert read("pipeline_self_ms.serve", run) == pytest.approx(40e-3)
    # 256 rows x 1 MFLOP over 40 us at 1 TFLOP/s
    assert read("projection_roofline", run) == pytest.approx(
        100 * 256e6 / (40e-6 * 1e12))
    unprof = run.unprofiled()
    secs = sum(r["t_done"] - r["t_send"] for r in unprof)
    assert read("mfu_pct.bulk", run) == pytest.approx(
        100 * len(unprof) * 1e6 / (secs * 1e12))


def test_shares_of_a_peak_are_left_out_without_one():
    run = record(tracing.Trace(trace_events()))
    run.peak_bf16 = None
    assert read("projection_roofline", run) is None
    assert read("mfu_pct.bulk", run) is None


def test_overlapping_ranges_count_device_time_once():
    # a second reconstruct range whose first correlated kernel starts
    # inside the first range's device interval: busy time counted once
    events = trace_events() + [
        ev("user_annotation", tracing.RECONSTRUCT, 31, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 32, 1, corr=3),
        ev("kernel", "late_op", 50, 8, tid=7, corr=3),
    ]
    t = tracing.Trace(events)
    assert t.range_device_s(tracing.RECONSTRUCT) == pytest.approx(40e-6)
    assert t.range_device_s(tracing.RECONSTRUCT) <= t.busy_s


def test_range_cut_at_its_request():
    events = trace_events() + [
        ev("kernel", "stray", 97, 2, tid=7, corr=2)]
    t = tracing.Trace(events)
    spans = t.range_spans(tracing.RECONSTRUCT)
    assert spans[0][3] == 95        # the request 5..95 ends the interval
