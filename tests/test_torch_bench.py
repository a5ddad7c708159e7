"""bench_torch.py, the port's north-star benchmark, on the CPU against the
JAX package's bench.py: the same cases as tests/test_driver_contract.py
and tests/test_round4_fixes.py hold for bench.py (records, supervisor,
deadline, diagnostic, the int8 stamp, the deep leg's fallback), and
parity of the two (the last record's keys, metric and unit; the leg plan
under each stamp state). Tiny sizes, --device cpu: the worker's kernel
requests resolve to the plain paths there, as bench.py's do off the TPU.
"""

import io
import json
import os
import subprocess
import sys
import time
from contextlib import redirect_stdout

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TINY = ["--batch", "16", "--deep_batch", "8", "--rec_rr", "2",
        "--rec_iters", "2", "--repeats", "1", "--deadline", "0"]
PORT_DEEP_CFG = os.path.join(ROOT, "defensegan_torch", "configs", "gans",
                             "mnist.yml")
JAX_DEEP_CFG = os.path.join(ROOT, "defensegan_tpu", "configs", "gans",
                            "mnist.yml")


def _records(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.strip()]


def _run_main(module, monkeypatch, argv):
    """module.main() in this process; the stdout records."""
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", [module.__name__ + ".py"] + argv)
    with redirect_stdout(buf):
        with pytest.raises(SystemExit) as e:
            module.main()
        assert e.value.code in (0, None)
    recs = _records(buf.getvalue())
    assert recs, "worker printed no record"
    return recs


# ------------------------------------------------ the records (driver contract)
def test_bench_main_emits_parseable_records(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # no export -> the seeded init
    import bench_torch

    from defensegan_torch.cli.bench import leg_launches

    recs = _run_main(bench_torch, monkeypatch,
                     ["--device", "cpu", "--batch", "32", "--rec_rr", "2",
                      "--rec_iters", "3", "--repeats", "1", "--deep_cfg",
                      "", "--deadline", "0"])
    # EVERY line is a parseable record, the LAST one the final one
    for rec in recs:
        assert rec["metric"] == "mnist_reconstructions_per_sec_per_chip"
        assert rec["value"] > 0
        assert rec["vs_baseline"] == round(rec["value"] / 1000.0, 4)
        assert rec["device"]["type"] == "cpu"
    assert all(r.get("partial") for r in recs[:-1])
    rec = recs[-1]
    assert "partial" not in rec
    # on the CPU the pallas request runs the plain packed path, and the
    # record names what ran
    assert [r["kernel"] for r in recs] == ["xla", "packed"]
    assert rec["gen_arch"] == "wide"
    assert "deep_value" not in rec  # --deep_cfg '' skips the deep leg
    # each leg's launches on stderr: none on the CPU, where no kernel runs
    assert leg_launches(capsys.readouterr().err) == {
        "headline_xla": {}, "headline_pallas": {}}


def test_bench_deep_fields(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    import bench_torch

    recs = _run_main(bench_torch, monkeypatch,
                     ["--device", "cpu", "--batch", "16", "--deep_batch",
                      "16", "--rec_rr", "2", "--rec_iters", "2",
                      "--repeats", "1", "--deep_cfg", PORT_DEEP_CFG,
                      "--deadline", "0"])
    rec = recs[-1]
    assert rec["deep_kernel"] == "xla"  # the deep model's plain path
    assert rec["deep_value"] > 0
    assert rec["deep_vs_baseline"] == round(rec["deep_value"] / 1000.0, 4)
    assert rec["deep_unit"].startswith("recon/s (R=2, L=2, batch=16, xla, "
                                       "gen=deep/dim64)")


# ------------------------------------------------ supervisor and deadline
def _run_supervisor(monkeypatch, capsys, worker_py, deadline=5.0):
    import bench_torch

    real_popen = subprocess.Popen

    def fake_popen(cmd, **kw):
        return real_popen([sys.executable, "-c", worker_py], **kw)

    monkeypatch.setattr(bench_torch.subprocess, "Popen", fake_popen)
    args = type("A", (), {"deadline": deadline})()
    rc = bench_torch.supervise(args, [])
    out = capsys.readouterr()
    return rc, _records(out.out), out.err


def test_supervisor_relays_incremental_records(monkeypatch, capsys):
    worker = ("import json\n"
              "print(json.dumps({'metric': 'm', 'value': 1.0,"
              " 'partial': True}), flush=True)\n"
              "print(json.dumps({'metric': 'm', 'value': 2.0}),"
              " flush=True)\n")
    rc, recs, _ = _run_supervisor(monkeypatch, capsys, worker)
    assert rc == 0
    assert [r["value"] for r in recs] == [1.0, 2.0]
    assert "partial" not in recs[-1]


def test_supervisor_kills_hung_worker_keeps_last_record(monkeypatch,
                                                        capsys):
    # one record, then a hang (a wedged CUDA init or build): killed at the
    # deadline, the relayed record stands
    worker = ("import json, time\n"
              "print(json.dumps({'metric': 'm', 'value': 3.0,"
              " 'partial': True}), flush=True)\n"
              "time.sleep(3600)\n")
    rc, recs, _ = _run_supervisor(monkeypatch, capsys, worker, deadline=12.0)
    assert rc == 0
    assert recs[-1]["value"] == 3.0


def test_supervisor_diagnostic_when_worker_never_reports(monkeypatch,
                                                         capsys):
    worker = "import sys; sys.exit(3)\n"
    rc, recs, _ = _run_supervisor(monkeypatch, capsys, worker, deadline=3.0)
    assert rc == 0
    rec = recs[-1]
    assert rec["metric"] == "mnist_reconstructions_per_sec_per_chip"
    assert rec["value"] == 0.0 and rec["vs_baseline"] == 0.0
    assert "deadline" in rec["error"]


def test_supervisor_diagnostic_names_the_build_stage(tmp_path, monkeypatch,
                                                     capsys):
    """A worker killed inside the kernels' build: the diagnostic's
    last_progress is the build's stage line, and the build's child (the
    nvcc stand-in) dies with the worker's process group."""
    pid_file = tmp_path / "child.pid"
    worker = ("import subprocess, sys, time\n"
              "print('worker: CUDA init ...', file=sys.stderr, flush=True)\n"
              "child = subprocess.Popen([sys.executable, '-c', "
              "'import time; time.sleep(3600)'])\n"
              f"open({str(pid_file)!r}, 'w').write(str(child.pid))\n"
              "print('worker: building kernels fused_projection_v2 (nvcc, "
              "cold unless build/kernels/ holds them)...', file=sys.stderr,"
              " flush=True)\n"
              "time.sleep(3600)\n")
    rc, recs, err = _run_supervisor(monkeypatch, capsys, worker,
                                    deadline=8.0)
    assert rc == 0
    assert recs[-1]["value"] == 0.0
    assert recs[-1]["last_progress"].startswith("worker: building kernels")
    assert "killed at deadline" in err
    child = int(pid_file.read_text())
    for _ in range(50):
        try:
            with open(f"/proc/{child}/stat") as f:
                if f.read().split()[2] == "Z":
                    break
        except OSError:
            break
        time.sleep(0.1)
    else:
        pytest.fail(f"the build's child {child} outlived the kill")


def test_worker_argv_strips_supervisor_flags():
    import bench_torch

    assert bench_torch.worker_argv(
        ["--batch", "8", "--deadline", "30", "--deadline=5", "--device",
         "cpu"]) == ["--batch", "8", "--device", "cpu"]


# ------------------------------------------------------ the card's stamp
def _export(tmp_path, step, manifest=True):
    root = tmp_path / "export"
    root.mkdir(exist_ok=True)
    (root / f"{step}.npz").write_bytes(b"")
    if manifest:
        (root / f"{step}.json").write_text(json.dumps({"step": step}))


def _write_stamp(tmp_path, **kw):
    (tmp_path / "export" / "int8_gate_cuda.json").write_text(json.dumps(kw))


CUDA = {"type": "cuda", "name": "NVIDIA H100 80GB HBM3",
        "power_limit": "700.00 W"}


def test_int8_gate_stamp(tmp_path):
    from defensegan_torch.cli.bench import int8_gate_stamp

    out = str(tmp_path)
    assert int8_gate_stamp(out) is None          # no export at all
    _export(tmp_path, 100)
    assert int8_gate_stamp(out) is None          # export but no stamp
    _write_stamp(tmp_path, step=100, device=CUDA, **{"pass": False})
    assert int8_gate_stamp(out) is None          # failing stamp
    _write_stamp(tmp_path, step=50, device=CUDA, **{"pass": True})
    assert int8_gate_stamp(out) is None          # another step's stamp
    _write_stamp(tmp_path, step=100, **{"pass": True},
                 device={"type": "cpu", "name": "cpu", "power_limit": None})
    assert int8_gate_stamp(out) is None          # measured on the CPU
    _write_stamp(tmp_path, step=100, **{"pass": True})
    assert int8_gate_stamp(out) is None          # no device at all
    _write_stamp(tmp_path, step=100, device=CUDA, **{"pass": True},
                 material_disagreement_int8=0.016)
    stamp = int8_gate_stamp(out)
    assert stamp and stamp["material_disagreement_int8"] == 0.016
    # a retrain advancing the export's step re-voids the stamp
    _export(tmp_path, 200)
    assert int8_gate_stamp(out) is None
    # corrupt stamp file -> None, not a crash
    (tmp_path / "export" / "int8_gate_cuda.json").write_text("{nope")
    assert int8_gate_stamp(out) is None


def test_int8_gate_stamp_reads_the_export_not_checkpoints(tmp_path):
    """The committed flagship has export/20000.npz and no checkpoints/
    <step>.pt: the stamp is matched against the export's step (its
    manifest's, else the file's), never against a torch checkpoint, and
    the JAX package's checkpoints/int8_gate.json is never read."""
    from defensegan_torch.ckpt.checkpoint import latest_step
    from defensegan_torch.cli.bench import export_step, int8_gate_stamp

    _export(tmp_path, 20000, manifest=False)
    (tmp_path / "checkpoints").mkdir()
    (tmp_path / "checkpoints" / "int8_gate.json").write_text(
        json.dumps({"step": 20000, "pass": True}))
    assert latest_step(str(tmp_path)) is None
    assert export_step(str(tmp_path)) == 20000
    assert int8_gate_stamp(str(tmp_path)) is None
    _write_stamp(tmp_path, step=20000, device=CUDA, **{"pass": True})
    assert int8_gate_stamp(str(tmp_path))["step"] == 20000
    # the committed flagship and its committed card stamp
    flagship = os.path.join(ROOT, "output", "gans", "mnist_fast")
    assert export_step(flagship) == 20000
    stamp = int8_gate_stamp(flagship)
    assert stamp["step"] == 20000 and stamp["device"]["type"] == "cuda"


# ------------------------------------------------ the deep leg's fallback
def test_measure_deep_fallback_to_auto(tmp_path, monkeypatch, capsys):
    """pallas_int8 is no deep request: with fallback_to_auto the deep leg
    measures the auto resolution (the plain xla path on the CPU), without
    it the leg refuses."""
    monkeypatch.chdir(tmp_path)
    from defensegan_torch.cli.bench import measure

    v, k, cfg = measure(PORT_DEEP_CFG, batch=8, rec_rr=2, rec_iters=2,
                        repeats=1, kernel="pallas_int8",
                        fallback_to_auto=True, device="cpu")
    assert v > 0
    assert k == "xla" and cfg.gen_arch == "deep"
    assert "measuring auto resolution" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="not runnable"):
        measure(PORT_DEEP_CFG, batch=8, rec_rr=2, rec_iters=2, repeats=1,
                kernel="pallas_int8", device="cpu")


def test_measure_writes_the_trace(tmp_path, monkeypatch):
    """--trace: one more call under torch.profiler, a Chrome trace."""
    monkeypatch.chdir(tmp_path)
    from defensegan_torch.cli.bench import CFG_DIR, measure

    v, k, _ = measure(os.path.join(CFG_DIR, "mnist_fast.yml"), 4, 2, 1, 1,
                      "xla", trace_dir=str(tmp_path / "trace"), device="cpu")
    assert v > 0 and k == "xla"
    (path,) = (tmp_path / "trace").iterdir()
    assert json.loads(path.read_text())["traceEvents"]


def test_measure_refused_request_is_not_runnable(tmp_path, monkeypatch):
    """A request the port's resolver refuses outright (pallas_v4 on the
    single-deconv flagship, where the JAX resolver degrades quietly) is
    "not runnable" without the fallback."""
    monkeypatch.chdir(tmp_path)
    from defensegan_torch.cli.bench import CFG_DIR, measure

    flagship = os.path.join(CFG_DIR, "mnist_fast.yml")
    # on the CPU every kernel request resolves to the plain path: the
    # resolver's CUDA branch decides, so ask it for CUDA
    from defensegan_torch.gan import defense_gan

    real = defense_gan.resolve_projection_kernel

    def on_cuda(gan, **kw):
        return real(gan, on_cuda=True, **kw)

    monkeypatch.setattr(defense_gan, "resolve_projection_kernel", on_cuda)
    with pytest.raises(RuntimeError, match="not runnable.*pallas_v4"):
        measure(flagship, 8, 2, 2, 1, "pallas_v4", device="cpu")


# ----------------------------------------------------- parity with bench.py
def test_last_record_matches_bench_py(tmp_path, monkeypatch):
    """Both mains at the same tiny flags (--deadline 0, in-process): the
    last records have the same keys but the port's `device`, the same
    metric, and the same unit strings (both run the plain paths here)."""
    monkeypatch.chdir(tmp_path)
    import bench
    import bench_torch

    jax_rec = _run_main(bench, monkeypatch,
                        TINY + ["--deep_cfg", JAX_DEEP_CFG])[-1]
    port_rec = _run_main(bench_torch, monkeypatch,
                         TINY + ["--deep_cfg", PORT_DEEP_CFG,
                                 "--device", "cpu"])[-1]
    assert set(port_rec) == set(jax_rec) | {"device"}
    assert port_rec["metric"] == jax_rec["metric"]
    for key in ("unit", "deep_unit", "kernel", "deep_kernel", "gen_arch",
                "gen_dim"):
        assert port_rec[key] == jax_rec[key], key


def _plan_dirs(tmp_path, state):
    """A run dir holding a JAX checkpoint step and a port export of step
    100, each package's stamp in `state` (None, failing, passing), and a
    copy of each package's mnist_fast.yml pointed at it."""
    import yaml

    run = tmp_path / "run"
    (run / "checkpoints" / "100").mkdir(parents=True)
    _export(run, 100)
    if state is not None:
        ok = state == "passing"
        (run / "checkpoints" / "int8_gate.json").write_text(
            json.dumps({"step": 100, "pass": ok}))
        _write_stamp(run, step=100, device=CUDA, **{"pass": ok})
    cfgs = {}
    for pkg in ("defensegan_tpu", "defensegan_torch"):
        with open(os.path.join(ROOT, pkg, "configs", "gans",
                               "mnist_fast.yml")) as f:
            raw = yaml.safe_load(f)
        raw["OUTPUT_DIR"] = str(run)
        path = tmp_path / f"{pkg}.yml"
        path.write_text(yaml.safe_dump(raw))
        cfgs[pkg] = str(path)
    return cfgs


@pytest.mark.parametrize("state", [None, "failing", "passing"])
def test_worker_plans_the_legs_of_bench_py(tmp_path, monkeypatch, state):
    """Under each stamp state both workers measure the same legs in the
    same order (measure stubbed: the plan alone)."""
    monkeypatch.chdir(tmp_path)
    import bench
    import bench_torch
    import defensegan_torch.cli.bench as port_bench

    cfgs = _plan_dirs(tmp_path, state)
    plans = {}
    for pkg, mod, main, extra in (
            ("defensegan_tpu", bench, bench, []),
            ("defensegan_torch", port_bench, bench_torch,
             ["--device", "cpu"])):
        calls = []

        def fake_measure(cfg_path, batch, rec_rr, rec_iters, repeats,
                         kernel, trace_dir=None, fallback_to_auto=False,
                         device=None, _calls=calls, _pkg=pkg):
            _calls.append((os.path.basename(cfg_path), batch, kernel,
                           fallback_to_auto))
            cfg = type("C", (), {"gen_arch": "wide", "gen_dim": 16})()
            return 100.0, kernel or "pallas", cfg

        monkeypatch.setattr(mod, "measure", fake_measure)
        _run_main(main, monkeypatch,
                  TINY + ["--cfg", cfgs[pkg]] + extra)
        plans[pkg] = [(c[0].replace(pkg + ".yml", "mnist_fast.yml"),) + c[1:]
                      for c in calls]
    assert plans["defensegan_torch"] == plans["defensegan_tpu"]
    kernels = [c[2] for c in plans["defensegan_torch"]]
    assert kernels == (["xla", "pallas"]
                       + (["pallas_int8"] if state == "passing" else [])
                       + ["pallas"])


# -------------------------------------------- imports and the card default
def test_import_bench_torch_leaves_torch_out():
    code = ("import sys, bench_torch\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'defensegan_torch', 'jax', 'defensegan_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=ROOT), timeout=60)


def test_default_device_refuses_without_a_card(tmp_path):
    """--device defaults to cuda: here, without a card, the worker exits
    non-zero and prints no record (no fallback to the CPU)."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_torch.py")] + TINY,
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_supervised_run_without_a_card_is_the_diagnostic(tmp_path):
    """Through the supervisor the same run ends in the diagnostic record,
    rc 0, whose last_progress is the worker's refusal."""
    argv = [a for a in TINY if a not in ("--deadline", "0")]
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_torch.py"), "--deadline",
         "20"] + argv, cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0
    rec = _records(out.stdout)[-1]
    assert rec["value"] == 0.0 and "error" in rec
    assert "no CUDA device" in rec["last_progress"]
