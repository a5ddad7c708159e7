"""Runs of every cell at a tiny size on the CPU (the harness's look for a
chip skipped): the result line, the metrics each cell reports, and the
check coming out false when the timed path is broken underneath."""

import json

import pytest
import torch

import bench_tiny
from benchmark import spec
from bench_tiny import BENCH

CELLS = [w["name"] for w in BENCH["workloads"]]


def images(cell):
    return 8 if spec.cell(BENCH, cell)["traffic"].startswith("bulk") else 1


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell, trace, monkeypatch):
    bench_tiny.tiny(spec.cell(BENCH, cell)["config"], images(cell),
                    monkeypatch)
    out = bench_tiny.run(cell, trace=trace)
    assert out["correct"], out["checked"]
    assert list(out)[-1] == "checked"
    json.dumps(out)
    section = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in spec.cell_metrics(BENCH, cell, section)}
    got = set(out["metrics"])
    # on the CPU no share of a GPU peak is computed, and the trace has no
    # device ops to end a reconstruct call's span
    assert got <= want
    assert want - got <= {"projection_roofline", "mfu_pct.bulk",
                          "pipeline_self_ms.serve"}
    for m in out["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_inputs():
    from benchmark.harness import Inputs
    conf = spec.config(BENCH, "mnist")
    traffic = dict(spec.traffic("serve1"), pool_images=16)
    conf = dict(conf, pipeline=dict(conf["pipeline"],
                                    calibration_images=8))
    a = Inputs(conf, traffic, 2 ** 31 + 5, torch.device("cpu"))
    b = Inputs(conf, traffic, 2 ** 31 + 5, torch.device("cpu"))
    c = Inputs(conf, traffic, 2 ** 31 + 6, torch.device("cpu"))
    assert all(torch.equal(a.gen_w[k], b.gen_w[k]) for k in a.gen_w)
    assert (a.pool == b.pool).all() and not (a.pool == c.pool).all()
    ra, rb = a.request(3), b.request(3)
    assert ra.offset == rb.offset and torch.equal(ra.table, rb.table)
    assert not torch.equal(a.gen_w["fc_in/kernel"], c.gen_w["fc_in/kernel"])


def _unchanged_step(gen_apply, z, v, x_flat, momentum, rec_lr,
                    create_graph):
    return z.detach(), v


def _half_step(real, restarts=2):
    """Every other image's rows (image-major, `restarts` rows an image)
    left as they came: half of each chunk's images never projected."""
    def step(gen_apply, z, v, x_flat, momentum, rec_lr, create_graph):
        z2, v2 = real(gen_apply, z, v, x_flat, momentum, rec_lr,
                      create_graph)
        image = torch.arange(z.shape[0])[:, None] // restarts
        keep = image % 2 == 1
        return torch.where(keep, z2, z.detach()), torch.where(keep, v2, v)
    return step


def _frozen_restarts(real, restarts=2):
    """The upper half of every image's restarts left as they came."""
    def step(gen_apply, z, v, x_flat, momentum, rec_lr, create_graph):
        z2, v2 = real(gen_apply, z, v, x_flat, momentum, rec_lr,
                      create_graph)
        restart = torch.arange(z.shape[0])[:, None] % restarts
        keep = restart < restarts // 2
        return torch.where(keep, z2, z.detach()), torch.where(keep, v2, v)
    return step


def _altered_x_hat(real):
    def select(losses, z_final, gen_apply, image_shape=None):
        res = real(losses, z_final, gen_apply, image_shape)
        x_hat = res.x_hat.clone()
        x_hat[0] = 1.0 - x_hat[0]
        return res._replace(x_hat=x_hat)
    return select


def _altered_rec_err(real):
    def predict(self, x, *a, **kw):
        res = real(self, x, *a, **kw)
        err = res.rec_err.copy()
        err[0] *= 2.0
        return res._replace(rec_err=err)
    return predict


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "frozen_restarts", "altered_x_hat",
                                   "altered_rec_err", "other_path"])
@pytest.mark.parametrize("cell", ["mnist_fast.bulk10k", "mnist.serve1"])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from defensegan_torch.defense import pipeline, project
    conf = bench_tiny.tiny(spec.cell(BENCH, cell)["config"], images(cell),
                           monkeypatch, sample_images=8)
    if fault == "unchanged_state":
        monkeypatch.setattr(project, "_step", _unchanged_step)
    elif fault == "half_batch":
        monkeypatch.setattr(project, "_step", _half_step(project._step))
    elif fault == "frozen_restarts":
        monkeypatch.setattr(project, "_step",
                            _frozen_restarts(project._step))
    elif fault == "other_path":
        # the same float32 numbers on a path the configuration does not
        # state: only the path check can see it
        other = "packed" if conf["path"] == "xla" else "xla"
        conf["program_overrides"]["PROJECTION_KERNEL"] = other
    elif fault == "altered_x_hat":
        monkeypatch.setattr(project, "select_restarts",
                            _altered_x_hat(project.select_restarts))
    else:
        monkeypatch.setattr(pipeline.DefendedPipeline, "predict",
                            _altered_rec_err(
                                pipeline.DefendedPipeline.predict))
    out = bench_tiny.run(cell, seconds=0.3)
    assert not out["correct"], out["checked"]
    if fault == "other_path":
        assert out["checked"]["path_mismatch"]["value"] > 0
