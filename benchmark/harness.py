"""One run of one cell: set-up, the measured window, the traced part, the
comparison with the reference, and the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration file, its traffic file under ``benchmark/workloads/``, the
adapter the configuration names under ``benchmark/adapters/``, and one
reader per metric under ``benchmark/metrics/``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from . import compare, data, fields, roofline
from . import trace as tracing
from .reference import physics

ROOT = Path(__file__).resolve().parents[1]
# top-level modules that may not be loaded in a run (the JAX reference
# package of the system under test, and JAX itself)
BANNED = ("jax", "jaxlib", "flax", "cloudsc2jax")
WINDOW_SPAN = "bench.window"
CALL_SPAN = "bench.call"


class RunError(Exception):
    """A run that cannot give a result; ``code`` is its exit code."""

    def __init__(self, message: str, code: int = 1):
        super().__init__(message)
        self.code = code


def load_cell(root: Path, name: str):
    """``(benchmark, cell, config, traffic)`` of the workload ``name``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise RunError(f"BENCHMARK.json has no workload {name!r}", 2)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / "benchmark" / "workloads" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def cell_metrics(bench: dict, cell: dict, group: str) -> list:
    """The metrics of ``group`` ("end_to_end" or "per_layer") the cell
    reports."""
    return [m for m in bench[group]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def reader(root: Path, name: str):
    """The ``read(ctx)`` function of ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def card_power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip() or None


class _Clock:
    """Per-call device times: CUDA events on a card, the host's clock on the
    CPU (where a call has ended when it returns)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append([ev, None])
        else:
            self.marks.append([time.perf_counter(), None])

    def stop(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks[-1][1] = ev
        else:
            self.marks[-1][1] = time.perf_counter()

    def ms(self) -> list:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in self.marks]
        return [(b - a) * 1e3 for a, b in self.marks]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, root: Path = ROOT, device: Optional[str] = None,
        ngptot: Optional[int] = None, adapter: Optional[str] = None):
    """One run; returns ``(result, checks, extra)``.  ``device``, ``ngptot`` and
    ``adapter`` replace the card, the configuration's columns and its
    adapter (the tests run the plain versions on the CPU at a small size,
    and the control in the program's place)."""
    bench, cell, config, traffic = load_cell(root, workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{workload} needs {cell['chips']} CUDA device(s); "
                           f"found {torch.cuda.device_count()}", 3)
        device = "cuda:0"
    dev = torch.device(device)
    ncol = ngptot or config["ngptot"]
    config = {**config, "ngptot": ncol}
    dtype = data.DTYPES[config["dtype"]]

    # ---- set-up: inputs from the seed, the system's entry, the warm-up
    marks = {"start": time.perf_counter()}
    if dev.type == "cuda":
        torch.cuda.init()
        marks["card"] = time.perf_counter()
    c = physics.consts(config["ptsphy"], config["levapls2"])
    unit_pqs = config["unit"] != "nl"
    stored = data.make_sets(seed, traffic["pool_sets"], nlon=config["stored_columns"],
                            nlev=config["klev"], c=c, dtype=dtype, pqs=unit_pqs)
    ceta = data.ceta(stored[0])
    marks["stored columns"] = time.perf_counter()
    port = importlib.import_module(f"benchmark.adapters.{adapter or config['adapter']}")
    params = port.params(c, ceta, config)
    call = port.entry(params, config, traffic)
    marks["system's import"] = time.perf_counter()
    xs = [port.inputs(data.tile(s, ncol, dev), config, traffic) for s in stored]
    pool = len(xs)
    _sync(dev)
    marks["tiled pool"] = time.perf_counter()

    plan = np.random.default_rng(np.random.SeedSequence([int(seed), 1]))
    sample_call = int(plan.integers(0, traffic["sample_within"]))
    sample_cols = torch.from_numpy(np.sort(plan.choice(
        ncol, size=min(traffic["sample_columns"], ncol), replace=False))).to(dev)

    def keep(out):
        return {k: v.index_select(1, sample_cols) for k, v in port.outputs(
            out, config, traffic).items()}

    for i in range(max(traffic["warmup_calls"], pool)):
        out = call(xs[i % pool])
    keep(out)
    del out
    _sync(dev)
    marks["warm-up"] = time.perf_counter()
    setup_s = marks["warm-up"] - t_start
    names = list(marks)
    setup_parts = {"imports": marks["start"] - t_start,
                   **{b: marks[b] - marks[a] for a, b in zip(names, names[1:])}}

    # ---- the window: one caller, calls back to back, one synchronise
    if dev.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        mem0 = torch.cuda.memory_allocated(dev)
    clock = _Clock(dev)
    kept = None
    trace_from = seconds * traffic["trace_after"] if trace else None
    traced = None
    n = 0
    t0 = time.perf_counter()
    while True:
        if (trace_from is not None and n > sample_call
                and time.perf_counter() - t0 >= trace_from):
            trace_from = None
            traced = _traced_calls(call, xs, n, traffic["trace_calls"], dev, clock)
            n += traffic["trace_calls"]
        clock.start()
        out = None
        out = call(xs[n % pool])
        clock.stop()
        if n == sample_call:
            kept = keep(out)
        n += 1
        if time.perf_counter() - t0 >= seconds and n > sample_call:
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    if trace and traced is None:  # a window shorter than one call
        traced = _traced_calls(call, xs, n, traffic["trace_calls"], dev, _Clock(dev))

    ctx = SimpleNamespace(
        config=config, traffic=traffic, cell=cell, setup_s=setup_s, ncol=ncol,
        calls=n, window_s=window_s, call_ms=clock.ms(), work_mem_bytes=None,
        trace=None, traced_calls=0, host_ms=[],
        least_time_s=roofline.least_time_s(config, traffic))
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": 0}
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        ctx.work_mem_bytes = peak - mem0
        device_info["memory_peak_bytes"] = max(peak, setup_peak)
    if trace:
        ctx.trace, ctx.traced_calls = traced
        ctx.host_ms = _host_spans(call, xs, traffic["host_calls"], dev)
        device_info["busy_s"] = ctx.trace.busy_s()
        device_info["window_s"] = ctx.trace.window_s
    last = port.outputs(out, config, traffic)
    last_set, sample_set = (n - 1) % pool, sample_call % pool
    del out, xs, call

    # ---- the comparison, after the window, on the outputs kept
    t_ref = time.perf_counter()
    ref_sets = sorted({last_set, sample_set})
    x_ref = {k: torch.cat([stored[i][k].double().T for i in ref_sets])
             for k in stored[0]}
    nlon = config["stored_columns"]
    if config["unit"] == "nl":
        ref = (physics.nl(x_ref, ceta, c, ldrain1d=config["ldrain1d"]),)
    else:
        ref = physics.tlad(x_ref, ceta, c, dscale=config["dscale"],
                           lregcl=config["lregcl"], ldrain1d=config["ldrain1d"])
    names = fields.expected(config["unit"], traffic["contract"],
                            traffic.get("write_primal", True))

    def ref_of(set_index):
        lo = ref_sets.index(set_index) * nlon
        return {k: v[lo:lo + nlon] for k, v in fields.reference_fields(ref, names).items()}

    tol = config["tolerance"]
    checked = [compare.call_readings(last, ref_of(last_set), torch.arange(ncol), tol),
               compare.call_readings(kept, ref_of(sample_set), sample_cols, tol)]
    readings = compare.worst(checked)
    correct, checks = compare.verdict(readings, config["limits"])
    failed = sum(not compare.verdict(r, config["limits"])[0] for r in checked)

    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell, group):
        value = reader(root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": n, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    extra = {"call_ms_median": float(np.median(ctx.call_ms)), "calls": n,
             "widest": {k: v for k, v in readings.items() if k.startswith("widest_")},
             "check_s": time.perf_counter() - t_ref, "setup_parts": setup_parts,
             "window_s": window_s, "setup_s": setup_s,
             "power_limit": card_power_limit() if dev.type == "cuda" else None}
    return result, checks, extra


def _traced_calls(call, xs, n0: int, count: int, dev: torch.device, clock: _Clock):
    """``count`` calls under ``torch.profiler``, from a drained device to a
    synchronise, each in a span of its own; ``(trace, count)``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(dev)
    prof = profile(activities=activities)
    prof.start()
    with record_function(WINDOW_SPAN):
        for i in range(n0, n0 + count):
            clock.start()
            with record_function(CALL_SPAN):
                out = None
                out = call(xs[i % len(xs)])
            clock.stop()
        del out
        _sync(dev)
    prof.stop()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return tracing.read(path, WINDOW_SPAN), count


def _host_spans(call, xs, count: int, dev: torch.device) -> list:
    """Host milliseconds of ``count`` calls, each issued to a drained device
    so that no launch waits for room in the queue."""
    spans = []
    for i in range(count):
        _sync(dev)
        t = time.perf_counter()
        out = call(xs[i % len(xs)])
        spans.append((time.perf_counter() - t) * 1e3)
        del out
    _sync(dev)
    return spans
