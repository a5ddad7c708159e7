"""encode_device_ms.serve (benchmark/metrics/encode_device_ms.serve.py) on
a hand-made Chrome trace: the device time of the ops launched inside each
request's `projection.encode` spans, and None for a program without the
span."""

import pytest

import bench_tiny
from benchmark import spec, tracing
from benchmark.harness import RunRecord

NAME = "encode_device_ms.serve"


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


def request(t0, c0, encode=(4, 3, 2)):
    """One request at t0 (ids from c0): a copy launched before the
    reconstruct, two projection.encode spans whose ops run `encode` us
    (a conv, then an overlapping elementwise op, then the merge), the
    loop's library kernels (no correlation id) and the classifier after
    them. Device: copy 2 us, encode ops, loop 40 us, classifier 3 us."""
    conv, act, merge = encode
    return [
        span(tracing.REQUEST, t0, 200),
        span("pipeline.predict", t0 + 2, 190),
        launch(t0 + 3, c0, "cudaMemcpyAsync"),
        span("gan.reconstruct", t0 + 5, 60),
        span("projection.encode", t0 + 6, 6),
        launch(t0 + 7, c0 + 1), launch(t0 + 9, c0 + 2),
        span("projection.encode", t0 + 13, 4),
        launch(t0 + 14, c0 + 3),
        span("projection.loop", t0 + 20, 10),
        span("pipeline.classify", t0 + 100, 5), launch(t0 + 101, c0 + 4),
        kernel("Memcpy HtoD", t0 + 4, 2, corr=c0, cat="gpu_memcpy"),
        kernel("conv", t0 + 10, conv, corr=c0 + 1),
        kernel("leaky_relu", t0 + 10 + conv - 1, act, corr=c0 + 2),
        kernel("where", t0 + 30, merge, corr=c0 + 3),
        kernel("gemm_sm90", t0 + 40, 40),
        kernel("classifier", t0 + 110, 3, corr=c0 + 4),
    ]


def record(events):
    reqs = [dict(n=1, rows=2, profiled=True, t_send=i * 1e-3,
                 t_done=i * 1e-3 + 2e-4) for i in range(3)]
    return RunRecord(setup_s=9.5, image_flops=1_000_000, peak_bf16=1e12,
                     requests=reqs, trace=tracing.Trace(events))


def events(encodes=((4, 3, 2), (6, 3, 2), (5, 1, 4))):
    out = [span(tracing.WINDOW, 0, 1000)]
    for i, enc in enumerate(encodes):
        out += request(300 * i + 10, 10 * i + 1, enc)
    return out


def read(run):
    return spec.metric_reader(NAME)(run)


def test_each_request_by_hand():
    """conv and leaky_relu overlap by 1 us: 4 + 3 - 1 + 2 = 8 us, then
    6 + 3 - 1 + 2 = 10, 5 + 1 - 1 + 4 = 9 (the copy, the loop and the
    classifier are launched outside the spans); median 9 us."""
    assert read(record(events())) == pytest.approx(9e-3)


def test_one_request():
    assert read(record(events(((4, 3, 2),)))) == pytest.approx(8e-3)


def test_none_without_the_span():
    """The parent program's trace has no projection.encode: None, so the
    result line leaves the metric out; None too with no trace."""
    bare = [e for e in events() if e["name"] != "projection.encode"]
    assert read(record(bare)) is None
    run = record(events())
    run.trace = None
    assert read(run) is None


def test_the_cell_reads_it():
    """The metric is declared for the encoder cell alone."""
    bench = spec.load_benchmark()
    m = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert len(m) == 1 and m[0]["workloads"] == ["mnist_fast_enc.serve1"]
    assert m[0]["moves"] == "latency_p95_ms"


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
def test_the_encoder_cell_runs_tiny_with_the_program(trace, monkeypatch):
    """mnist_fast_enc.serve1 at bench_tiny's encoder size on the CPU with
    the program as it is (no stand-in): correct, and the traced line
    reads the metric (0 here: the CPU's trace has no device ops)."""
    bench_tiny.tiny_encoder(1, monkeypatch)
    out = bench_tiny.run("mnist_fast_enc.serve1", trace=trace)
    assert out["correct"], out["checked"]
    want = {m["name"] for m in spec.cell_metrics(
        bench_tiny.BENCH, "mnist_fast_enc.serve1",
        "per_layer" if trace else "end_to_end")}
    assert (NAME in want) == trace
    if trace:
        assert out["metrics"][NAME]["value"] == 0.0
