"""What a cell is made of, found by the names in BENCHMARK.json.

  BENCHMARK.json                 cells, metrics, bounds, run length
  benchmark/configs/<c>.json     a configuration (the file BENCHMARK.json
                                 names for it)
  benchmark/traffic/<t>.json     a traffic mix; its `loop` names the loop
                                 kind, benchmark/traffic/<loop>.py
  benchmark/metrics/<m>.py       one metric: read(run) -> number or None

A later cell, configuration, mix or metric is a new file and a new entry;
nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def cell(bench: Dict, name: str) -> Dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: Dict, name: str, root: str = ROOT) -> Dict:
    entry = _by_name(bench["configs"], name, "config")
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def traffic(name: str) -> Dict:
    with open(os.path.join(BENCH_DIR, "traffic", name + ".json")) as f:
        return json.load(f)


def _load_file(path: str, label: str):
    mod_name = "benchmark_" + label.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop(kind: str):
    """The traffic loop module benchmark/traffic/<kind>.py."""
    return _load_file(os.path.join(BENCH_DIR, "traffic", kind + ".py"),
                      "loop_" + kind)


def metric_reader(name: str) -> Callable:
    """read(run) of benchmark/metrics/<name>.py."""
    return _load_file(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                      "metric_" + name).read


def cell_metrics(bench: Dict, cell_name: str, section: str) -> List[Dict]:
    """The metrics of `section` ('end_to_end' or 'per_layer') that this
    cell reports: those listing it, and those listing no cells."""
    return [m for m in bench[section]
            if cell_name in m.get("workloads", [cell_name])]
