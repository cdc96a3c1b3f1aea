"""The benchmark's harness on the CPU, through the system's plain versions:
each cell at a small size, the last line, cells and metrics found by name,
seeded data, and the check on the modules a run loads.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from benchmark import data, harness, run
from benchmark.reference import physics

from .conftest import NGPTOT, ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 12345  # past 32 signed bits: a run takes seeds that large


def small_run(root, workload, trace=False, seed=SEED, **kw):
    return harness.run(workload, seed, 0.2, trace, t_start=time.perf_counter(),
                       root=root, device="cpu", ngptot=NGPTOT, **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_plain_versions(small_root, workload):
    result, checks, _ = small_run(small_root, workload)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert {"columns_per_s", "call_ms_p95", "setup_s"} <= set(result["metrics"])
    # the device's memory is not read on the CPU, and no number stands in for it
    assert "work_mem_gb" not in result["metrics"]
    kinds = {"primal"} if workload.startswith("nl.") else {"tangent", "adjoint"}
    assert kinds | {"copies"} <= set(checks)
    assert checks["copies"]["value"] == 0.0


def test_traced_run_reports_host_spans_and_breakdown_shape(small_root):
    result, _, _ = small_run(small_root, "nl.stream", trace=True)
    assert result["correct"]
    assert set(result["metrics"]) == {"host_ms"}  # no device trace on the CPU
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_last_line_shape(small_root, monkeypatch, capsys):
    real = harness.run

    def on_cpu(workload, seed, seconds, trace, *, t_start):
        return real(workload, seed, seconds, trace, t_start=t_start,
                    root=small_root, device="cpu", ngptot=NGPTOT)

    monkeypatch.setattr(harness, "run", on_cpu)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", "tlad.standard", "--seed", str(SEED),
                       "--seconds", "0.2", "--trace", "0"])
    assert rc == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert list(line["checks"]) == ["primal", "tangent", "adjoint", "copies"]
    err = capsys.readouterr().err.strip().splitlines()
    assert [e.split(":")[0] for e in err[-4:]] == ["check primal", "check tangent",
                                                   "check adjoint", "check copies"]


def test_run_without_a_card_exits_nonzero_without_a_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", "nl.stream", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and buf.getvalue() == ""


def test_new_cell_traffic_config_and_metric_found_by_name(small_root):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric as new files and entries; the harness finds them."""
    bench_path = small_root / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    cfg = json.loads((small_root / "benchmark/configs/cloudsc2-nl-f32.json").read_text())
    cfg["name"] = "cloudsc2-nl-f32-b"
    (small_root / "benchmark/configs/cloudsc2-nl-f32-b.json").write_text(json.dumps(cfg))
    traffic = json.loads((small_root / "benchmark/workloads/stream.json").read_text())
    traffic["pool_sets"] = 3
    (small_root / "benchmark/workloads/stream3.json").write_text(json.dumps(traffic))
    (small_root / "benchmark/metrics/calls_issued.py").write_text(
        "def read(ctx):\n    return float(ctx.calls)\n")
    bench["configs"].append({**bench["configs"][0], "name": "cloudsc2-nl-f32-b",
                             "file": "benchmark/configs/cloudsc2-nl-f32-b.json"})
    bench["workloads"].append({"name": "nlb.stream3", "config": "cloudsc2-nl-f32-b",
                               "traffic": "stream3", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "calls_issued", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "harness",
                               "moves": "columns_per_s", "workloads": ["nlb.stream3"]})
    bench_path.write_text(json.dumps(bench))
    result, _, _ = small_run(small_root, "nlb.stream3", trace=True)
    assert result["correct"]
    assert result["metrics"]["calls_issued"]["value"] == result["attempted"]
    # the other cells do not report it
    assert "calls_issued" not in small_run(small_root, "nl.stream", trace=True)[0]["metrics"]


def test_seeded_data_repeats():
    c = physics.consts(3600.0)
    kw = dict(nlon=100, nlev=137, c=c, dtype=torch.float32, pqs=True)
    a = data.make_sets(SEED, 2, **kw)
    b = data.make_sets(SEED, 2, **kw)
    other = data.make_sets(SEED + 1, 1, **kw)
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert not torch.equal(a[0]["pt"], a[1]["pt"])  # the pool's sets differ
    assert not torch.equal(a[0]["pt"], other[0]["pt"])
    assert torch.isfinite(torch.stack([v.sum() for v in a[0].values()])).all()
    # every seed gives the same sizes
    assert {k: v.shape for k, v in a[0].items()} == {k: v.shape for k, v in other[0].items()}


def test_tiling_is_cyclic():
    stored = {"pt": torch.arange(12.0).reshape(3, 4)}
    tiled = data.tile(stored, 10, "cpu")["pt"]
    assert torch.equal(tiled[:, 5], stored["pt"][:, 1])
    assert tiled.shape == (3, 10)


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    import types

    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "cloudsc2jax_torch_extra", types.ModuleType("x"))
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "cloudsc2jax.physics", types.ModuleType("x"))
    assert harness.banned_modules() == ["cloudsc2jax"]
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.banned_modules() == ["cloudsc2jax", "jax"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """In a process of its own: a whole small run, then the modules it loaded."""
    from .conftest import small_copy

    small_copy(tmp_path)
    code = (
        "import sys, time\n"
        "from benchmark import harness\n"
        f"harness.run('tlad.noprim', 3, 0.2, True, t_start=time.perf_counter(), "
        f"root=__import__('pathlib').Path({str(tmp_path)!r}), device='cpu', ngptot=40)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = set(eval(res.stdout.strip().splitlines()[-1]))
    assert "cloudsc2jax_torch" in loaded
    assert not loaded & set(harness.BANNED)


def test_reference_imports_nothing_of_the_system():
    code = ("import sys\n"
            "import benchmark.reference.physics, benchmark.data, benchmark.compare\n"
            "import benchmark.fields, benchmark.roofline\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = set(eval(res.stdout.strip().splitlines()[-1]))
    assert not loaded & {"cloudsc2jax_torch", *harness.BANNED}


def test_roofline_counts_the_calls_inputs_and_outputs_once():
    from benchmark import roofline

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    gb = {}
    for w in bench["workloads"]:
        _, _, config, traffic = harness.load_cell(ROOT, w["name"])
        gb[w["name"]] = roofline.call_work(config, traffic)[0] / 1e9
    assert gb["nl.stream"] == gb["nl.standard"] == pytest.approx(4.1314, abs=1e-4)
    assert gb["tlad.noprim"] == pytest.approx(7.1854, abs=1e-4)
    assert gb["tlad.standard"] == pytest.approx(8.6219, abs=1e-4)


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the main cell through ``python3 -m benchmark.run``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "nl.stream",
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert np.isfinite(line["metrics"]["columns_per_s"]["value"])


def test_trace_reading_and_device_metrics(tmp_path):
    """The device-side readers on a small synthetic profiler trace: busy
    time, the window clipped to the device's first and last operation, the
    gaps named by the host, PyTorch's share, the roofline share."""
    from types import SimpleNamespace

    from benchmark import trace

    events = [("user_annotation", "bench.window", 0, 100), ("user_annotation", "bench.call", 1, 30),
              ("kernel", "void cloudsc2_nl_kernel<float>", 10, 20),
              ("cuda_runtime", "cudaLaunchKernel", 28, 5),
              ("kernel", "void at::native::add_kernel", 35, 40), ("gpu_memcpy", "Memcpy DtoD", 70, 10)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": t, "dur": d} for c, n, t, d in events]}))
    tr = trace.read(path, "bench.window")
    assert tr.window == (10.0, 80.0)
    assert tr.busy_s() == pytest.approx(65e-6)
    assert tr.idle_gaps() == [["cudaLaunchKernel", pytest.approx(5e-6)]]
    assert [n for n, _ in tr.device_ops()] == ["void at::native::add_kernel",
                                               "void cloudsc2_nl_kernel<float>", "Memcpy DtoD"]
    ctx = SimpleNamespace(trace=tr, traced_calls=1, least_time_s=13e-6)
    read = {name: harness.reader(ROOT, name) for name in ("aten_ms", "idle_pct", "roofline_pct")}
    assert read["aten_ms"](ctx) == pytest.approx(0.050)  # the add kernel and the copy
    assert read["idle_pct"](ctx) == pytest.approx(100 * 5 / 70)
    assert read["roofline_pct"](ctx) == pytest.approx(20.0)
    # a reader that finds nothing to read returns nothing
    assert read["roofline_pct"](SimpleNamespace(trace=None, traced_calls=0)) is None
