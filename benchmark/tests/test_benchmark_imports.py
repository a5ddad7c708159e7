"""What the benchmark loads: never JAX, jaxlib, flax or the JAX package
(compared by whole top-level names: `defensegan_torch` begins with the
JAX package's name but is not it); the program only through
benchmark/system.py; and the reference nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "defensegan_tpu"}


def sources(sub=""):
    root = os.path.join(spec.BENCH_DIR, sub)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, spec.BENCH_DIR))
def test_no_source_imports_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_only_system_imports_the_program():
    for path in sources():
        rel = os.path.relpath(path, spec.BENCH_DIR)
        if rel == "system.py" or rel.startswith("tests" + os.sep):
            continue
        assert "defensegan_torch" not in top_level_imports(path), rel


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        names = top_level_imports(path)
        assert "defensegan_torch" not in names and not names & FORBIDDEN
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.generator, "
            "benchmark.reference.projection, "
            "benchmark.reference.classifier, benchmark.reference.detector, "
            "benchmark.check, benchmark.flops\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'defensegan_torch', 'jax', 'jaxlib', 'flax', "
            "'defensegan_tpu'}))" % spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax():
    code = f"""
import sys, time
sys.path.insert(0, {spec.ROOT!r})
sys.path.insert(0, {os.path.dirname(__file__)!r})
import torch
from benchmark import harness, spec
import bench_tiny

class MP:
    def setattr(self, obj, name, value):
        setattr(obj, name, value)

bench_tiny.tiny("mnist_fast", 8, MP())
out = bench_tiny.run("mnist_fast.bulk10k", seconds=0.05)
assert out["correct"], out
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    monkeypatch.setitem(sys.modules, "defensegan_tpu_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]
