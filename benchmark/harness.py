"""One run of one cell: set-up, the measured window, the check, the
result line.

Set-up (`setup_s`, from the start of run.py): CUDA, the inputs and
weights made from --seed (the encoder's too, where the configuration's
projection starts restart 0 at E(x): check.encoder_of), the program
built and calibrated on the configuration's clean calibration images,
one request of the cell's
traffic as warm-up (the program's kernels are built or loaded at their
first call, into the checkout's build/kernels/), and in a traced run the
profiler's own start-up (each phase's seconds are printed on standard
error beside the projection calls by path). Then the traffic loop drives
`DefendedPipeline.predict` for --seconds. After the window: the peak of
device memory is read, the program's state freed, and the sampled
answers are judged by the plain reference (check.py).
"""

from __future__ import annotations

import gc
import hashlib
import json
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import check, flops, spec, synthetic, tracing, weights
from benchmark.peaks import peak
from benchmark.reference import classifier as ref_classifier
from benchmark.reference import encoder as ref_encoder
from benchmark.reference.generator import weight_shapes
from benchmark.system import ProgramSystem, Recorder

# the restart-draw table of a request covers its images and this many
# rows more, so that any padding of a chunk finds draws
PAD_ROWS = 1024
FORBIDDEN = ("jax", "jaxlib", "flax", "defensegan_tpu")


def sub_seed(seed: int, *tags) -> int:
    """A 60-bit seed for one purpose of one run."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).hexdigest()
    return int(h[:15], 16)


@dataclass
class Request:
    index: Any
    offset: int
    n: int
    x: np.ndarray
    table: torch.Tensor


@dataclass
class Served:
    """What the window kept of a request the check may sample."""
    request: Request
    result: Any                 # the pipeline's result (numpy arrays)
    chunks: List[tuple]         # (lo, rows, ReconstructionResult)


@dataclass
class RunRecord:
    """What the metrics read (benchmark/metrics/<name>.py: read(run))."""
    setup_s: float
    image_flops: int            # the work to project an image (flops.py)
    peak_bf16: Optional[float]
    requests: List[Dict] = field(default_factory=list)
    trace: Optional[tracing.Trace] = None

    def unprofiled(self) -> List[Dict]:
        return [r for r in self.requests if not r["profiled"]]


class Inputs:
    """Everything a run hands the program and the reference, from the
    seed: weights, calibration images and draws, the traffic's pool of
    images and each request's draws. Under encoder init (`encoder`, the
    encoder's shape, not None) the encoder's weights too, and restart 0 of
    every table is NaN: the program starts it at its own E(x)."""

    def __init__(self, conf: Dict, traffic: Dict, seed: int,
                 device: torch.device):
        self.conf, self.traffic, self.seed = conf, traffic, seed
        self.device = device
        self.shape = check.shape_of(conf)
        self.gen_w = self._weights("generator", "gen",
                                   weight_shapes(self.shape))
        self.encoder = check.encoder_of(conf)
        self.enc_w = None if self.encoder is None else self._weights(
            "encoder", "encoder", ref_encoder.weight_shapes(self.encoder))
        cl = conf["classifier"]
        hw, _, c = conf["image_shape"]
        self.clf_w = weights.seeded(
            ref_classifier.weight_shapes(cl["num_classes"], hw, c),
            sub_seed(seed, "classifier"), device)
        ds = synthetic.data_seed(sub_seed(seed, "data"))
        calib_n = conf["pipeline"]["calibration_images"]
        self.x_calib = synthetic.make_synthetic(
            calib_n, hw, c, cl["num_classes"], seed=ds, split="dev")[0]
        self.pool = synthetic.make_synthetic(
            traffic["pool_images"], hw, c, cl["num_classes"], seed=ds,
            split="test")[0]
        self.z0_calib = self.table("calibration", calib_n)

    def _weights(self, module: str, tag: str,
                 shapes: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
        """One module's weights: the export's, or drawn from the seed."""
        w = self.conf["weights"]
        if w["kind"] == "export":
            out = weights.from_export(f"{spec.ROOT}/{w['file']}", module,
                                      self.device)
        else:
            out = weights.seeded(shapes, sub_seed(self.seed, tag),
                                 self.device)
        weights.check_shapes(out, shapes)
        return out

    def table(self, tag, n: int) -> torch.Tensor:
        """The restart draws [n + PAD_ROWS, R, k] of request `tag`; under
        encoder init restart 0's slot is NaN, not a draw."""
        gen = torch.Generator(device=self.device).manual_seed(
            sub_seed(self.seed, "z0", tag))
        t = torch.randn((n + PAD_ROWS, self.conf["projection"]
                         ["restarts"], self.shape.latent_dim),
                        generator=gen, device=self.device)
        if self.encoder is not None:
            t[:, 0] = float("nan")
        return t

    def request(self, index) -> Request:
        n = self.traffic["images_per_request"]
        rng = np.random.RandomState(
            sub_seed(self.seed, "offset", index) % (2 ** 32))
        off = int(rng.randint(0, self.pool.shape[0] - n + 1))
        return Request(index, off, n, self.pool[off:off + n],
                       self.table(index, n))


class Window:
    """The measured window: the traffic loop over the program, the
    reservoir of requests the check may sample (one decision per request,
    drawn from the seed), and in a traced run the profiled slice of whole
    requests 1 .. traffic["trace_requests"]."""

    def __init__(self, inputs: Inputs, system, recorder, trace: bool,
                 sample_rng: np.random.RandomState):
        self.inputs, self.system, self.recorder = inputs, system, recorder
        self.trace, self.rng = trace, sample_rng
        self.keep_n = max(1, math.ceil(
            inputs.conf["check"]["sample_images"]
            / inputs.traffic["images_per_request"]))
        self.first, self.last = 1, inputs.traffic["trace_requests"]
        self.kept: List[Served] = []
        self.requests: List[Dict] = []
        self.slot: Optional[int] = None
        self.prof = self.range = None

    def prepare(self, i: int) -> Request:
        if self.trace and i == self.last + 1:
            self.range.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
        req = self.inputs.request(i)
        slot = i if i < self.keep_n else int(self.rng.randint(0, i + 1))
        self.slot = slot if slot < self.keep_n else None
        self.recorder.start(req.table, keep=self.slot is not None)
        if self.trace and i == self.first:
            self.prof = _profiler()
            self.prof.__enter__()
            self.range = torch.profiler.record_function(tracing.WINDOW)
            self.range.__enter__()
        return req

    def send(self, req: Request) -> None:
        i = len(self.requests)
        profiled = self.trace and self.first <= i <= self.last
        if profiled:
            with torch.profiler.record_function(tracing.REQUEST):
                result = self.system.predict(req.x, self.recorder.z0_fn)
        else:
            result = self.system.predict(req.x, self.recorder.z0_fn)
        self.requests.append(dict(n=req.n, rows=self.recorder.rows,
                                  profiled=profiled))
        if self.slot is not None:
            served = Served(req, result, list(self.recorder.chunks))
            if self.slot < len(self.kept):
                self.kept[self.slot] = served
            else:
                self.kept.append(served)

    def run(self, seconds: float, record: RunRecord,
            min_requests: int = 1) -> List[Served]:
        loop = spec.loop(self.inputs.traffic["loop"])
        done = loop.drive(self.prepare, self.send, seconds, max(
            min_requests, self.last + 2 if self.trace else 1))
        for r, (t0, t1) in zip(self.requests, done):
            r["t_send"], r["t_done"] = t0, t1
        record.requests = self.requests
        if self.trace:
            record.trace = tracing.Trace(tracing.export(self.prof))
        return self.kept


def sample(inputs: Inputs, kept: List[Served], rng: np.random.RandomState
           ) -> check.Sample:
    """The sampled images' inputs and the program's answers for them."""
    pairs = [(s, j) for s in kept for j in range(s.request.n)]
    m = min(inputs.conf["check"]["sample_images"], len(pairs))
    pick = sorted(rng.choice(len(pairs), size=m, replace=False))
    dev = inputs.device
    x, z0, losses, z_star, x_hat = [], [], [], [], []
    pred, flagged, rec_err, margin = [], [], [], []
    tables = {}
    for p in pick:
        s, j = pairs[p]
        req = s.request
        if req.index not in tables:
            tables[req.index] = inputs.table(req.index, req.n)
        lo, rows, res = next(c for c in s.chunks if c[0] <= j < c[0] + c[1])
        x.append(torch.as_tensor(inputs.pool[req.offset + j]))
        z0.append(tables[req.index][j])
        losses.append(res.all_losses[j - lo])
        z_star.append(res.z_star[j - lo])
        x_hat.append(res.x_hat[j - lo])
        r = s.result
        pred.append(r.pred[j])
        flagged.append(r.flagged[j])
        rec_err.append(r.rec_err[j])
        margin.append(r.margin[j])
    return check.Sample(
        x=torch.stack(x).to(dev), z0=torch.stack(z0),
        all_losses=torch.stack(losses).float(),
        z_star=torch.stack(z_star).float(), x_hat=torch.stack(x_hat).float(),
        pred=np.asarray(pred), flagged=np.asarray(flagged, bool),
        rec_err=np.asarray(rec_err, np.float64),
        margin=np.asarray(margin, np.float64))


def _profiler():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def measure(inputs: Inputs, make_system: Callable, seconds: float,
            trace: bool, t_start: float, peak_bf16: Optional[float] = None,
            min_requests: int = 1, warm_up: bool = True,
            marks: Optional[List] = None):
    """Set-up's remainder, the window; returns (record, kept, recorder),
    the program freed but for what `kept` holds. (The readings of
    control.py take no warm-up: they time nothing.) marks: set-up's
    phases are appended as (name, time)."""
    marks = [] if marks is None else marks
    recorder = Recorder()
    system = make_system(recorder)
    marks.append(("system", time.perf_counter()))
    recorder.start(inputs.z0_calib, keep=False)
    system.calibrate(inputs.x_calib, recorder.z0_fn)
    marks.append(("calibration", time.perf_counter()))
    if warm_up:
        warm = inputs.request("warm-up")
        recorder.start(warm.table, keep=False)
        system.predict(warm.x, recorder.z0_fn)
    if trace:            # the profiler's own start-up belongs to set-up
        with _profiler():
            torch.ones(1, device=inputs.device).add_(1)
    recorder.traced = trace
    if inputs.device.type == "cuda":
        torch.cuda.synchronize(inputs.device)
    marks.append(("warm_up", time.perf_counter()))
    pr = inputs.conf["projection"]
    record = RunRecord(
        setup_s=marks[-1][1] - t_start,
        image_flops=flops.image_flops(inputs.shape, pr["restarts"],
                                      pr["iters"], inputs.encoder),
        peak_bf16=peak_bf16)
    win = Window(inputs, system, recorder, trace, np.random.RandomState(
        sub_seed(inputs.seed, "reservoir") % (2 ** 32)))
    kept = win.run(seconds, record, min_requests)
    return record, kept, recorder


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (whole names: `defensegan_torch` is not `defensegan_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def judge_kept(inputs: Inputs, kept: List[Served], paths: Dict[str, int]):
    """(correct, checked, diagnostics) of the window's sampled answers and
    of the run's projection calls by path."""
    s = sample(inputs, kept, np.random.RandomState(
        sub_seed(inputs.seed, "sample") % (2 ** 32)))
    numbers, diag = check.reference_numbers(
        inputs.conf, inputs.gen_w, inputs.clf_w,
        torch.as_tensor(inputs.x_calib, device=inputs.device),
        inputs.z0_calib[:inputs.x_calib.shape[0]], s, enc_w=inputs.enc_w)
    numbers["path_mismatch"] = sum(
        n for p, n in paths.items() if p != inputs.conf["path"])
    diag["paths"] = dict(paths)
    correct, checked = check.judge(numbers, inputs.conf["check"]["limits"])
    return correct, checked, diag


def run_cell(bench: Dict, cell: Dict, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float) -> Dict:
    """One run; returns the result line's object (module docstring)."""
    marks = [("imports", time.perf_counter())]
    conf = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    name = torch.cuda.get_device_name(device) \
        if device.type == "cuda" else "cpu"
    torch.zeros(1, device=device)
    marks.append(("device", time.perf_counter()))
    inputs = Inputs(conf, traffic, seed, device)
    marks.append(("inputs", time.perf_counter()))

    def make_system(recorder):
        return ProgramSystem(conf, inputs.gen_w, inputs.clf_w, device,
                             recorder, inputs.enc_w)

    record, kept, recorder = measure(inputs, make_system, seconds, trace,
                                     t_start, peak(name, "bf16_flops"),
                                     marks=marks)
    mem = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    phases, t = {}, t_start
    for phase, at in marks:
        phases[phase], t = round(at - t, 4), at
    print(f"paths {dict(recorder.paths)}, {len(record.requests)} requests, "
          f"setup {record.setup_s:.3f} s {json.dumps(phases)}",
          file=sys.stderr)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.cell_metrics(bench, cell["name"], section):
        value = spec.metric_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, checked, diag = judge_kept(inputs, kept, recorder.paths)
    out = {"correct": bool(correct), "attempted": len(record.requests),
           "failed": 0, "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": name, "count": cell["chips"],
                      "memory_peak_bytes": int(mem)}}
    if trace:
        t = record.trace
        out["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        out["breakdown"] = {"device_ops": t.top_ops(),
                            "idle_gaps": t.idle_gaps()}
    print("diagnostics " + json.dumps(diag), file=sys.stderr)
    for k, v in checked.items():
        verdict = "ok" if v["value"] <= v["limit"] else "FAIL"
        print(f"check {k} {v['value']!r} limit {v['limit']!r} {verdict}",
              file=sys.stderr)
    out["checked"] = checked
    return out
