"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
every configuration, traffic mix and metric by its name."""

import json
import os
import re

import pytest

from benchmark import spec
from bench_tiny import BENCH

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_and_sizes():
    path = os.path.join(spec.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    for w in cmd[1:]:
        if "/" in w or w.endswith(".py"):
            assert any(w == p or w.startswith(p + "/")
                       for p in BENCH["paths"])
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of the most cells later PRs may bring must fit
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keep_to_names_and_keys(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        allowed = KEYS[section] | ({"workloads"} if section in (
            "end_to_end", "per_layer") else set())
        assert KEYS[section] <= set(e) <= allowed, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert line(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                            "higher")


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["source"].startswith("https://")
        conf = spec.config(BENCH, c["name"])
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]


def test_workloads():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs)) and 1 <= len(pairs) <= 24
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(pairs) // 4)
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"])
        t = spec.traffic(w["traffic"])
        assert os.path.exists(os.path.join(spec.BENCH_DIR, "traffic",
                                           t["loop"] + ".py"))


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_it_must():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in spec.cell_metrics(BENCH, w["name"],
                                                    "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert spec.cell_metrics(BENCH, w["name"], "per_layer"), w["name"]


def test_per_layer_metrics_cells_report_their_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
        for c in cells:
            reported = [x["name"] for x in spec.cell_metrics(
                BENCH, c, "end_to_end")]
            assert m["moves"] in reported, (m["name"], c)
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


def test_every_metric_has_a_reader():
    for section in ("end_to_end", "per_layer"):
        for m in BENCH[section]:
            assert callable(spec.metric_reader(m["name"])), m["name"]


def test_files_dropped_in_are_found_by_name(tmp_path, monkeypatch):
    for d in ("metrics", "traffic", "configs"):
        (tmp_path / d).mkdir()
    (tmp_path / "metrics" / "new_metric.serve.py").write_text(
        "def read(run):\n    return 42.0\n")
    (tmp_path / "traffic" / "burst.json").write_text(json.dumps(
        {"loop": "open_loop", "images_per_request": 4}))
    (tmp_path / "traffic" / "open_loop.py").write_text(
        "def drive(prepare, send, seconds, min_requests=1):\n"
        "    return 'open'\n")
    (tmp_path / "configs" / "other.json").write_text(json.dumps(
        {"name": "other"}))
    monkeypatch.setattr(spec, "BENCH_DIR", str(tmp_path))
    assert spec.metric_reader("new_metric.serve")(None) == 42.0
    t = spec.traffic("burst")
    assert spec.loop(t["loop"]).drive(None, None, 1) == "open"
    bench = {"configs": [{"name": "other", "file": "configs/other.json"}]}
    assert spec.config(bench, "other", root=str(tmp_path)) == \
        {"name": "other"}


def test_cell_metrics_selects_by_workloads():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}]}
    assert [m["name"] for m in spec.cell_metrics(bench, "x",
                                                 "end_to_end")] == ["a", "b"]
    assert [m["name"] for m in spec.cell_metrics(bench, "y",
                                                 "end_to_end")] == ["a"]
