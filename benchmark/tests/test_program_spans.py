"""The readers of the program's spans (``benchmark/program_spans.py`` and the
metrics that use it) on the CPU: a traced run of every cell through the
plain versions, each new reader given a value from it, none where the run
had no device trace or the program has no spans, and the launch count on
a small synthetic trace.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import sys
from types import SimpleNamespace

import pytest

from benchmark import harness, program_spans, trace

from .conftest import ROOT
from .test_bench_harness import CELLS, small_run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = ("prelude_ms", "nl_sweep_ms", "tl_sweep_ms", "fwd_sweep_ms",
                "ad_sweep_ms", "glue_ms", "launches_per_call")


def _named(cell):
    return [m["name"] for m in harness.cell_metrics(BENCH, {"name": cell}, "per_layer")
            if m["name"] in SPAN_METRICS]


def _traced_ctx(root, cell, monkeypatch):
    """The context a traced run of ``cell`` handed its readers."""
    seen = []
    real = harness.reader

    def spy(root_, name):
        read = real(root_, name)
        return lambda ctx: (seen.append(ctx), read(ctx))[1]

    monkeypatch.setattr(harness, "reader", spy)
    result, _, _ = small_run(root, cell, trace=True)
    monkeypatch.setattr(harness, "reader", real)
    return result, seen[-1]


@pytest.mark.parametrize("cell", CELLS)
def test_span_readers_on_a_traced_run(small_root, monkeypatch, cell):
    names = _named(cell)
    assert names and "prelude_ms" in names and "launches_per_call" in names
    result, ctx = _traced_ctx(small_root, cell, monkeypatch)
    assert result["correct"]
    # the CPU's plain versions: no device trace, so no device metric
    assert not set(result["metrics"]) & set(SPAN_METRICS)
    # the same run as if its trace had a device operation: every reader
    # named for the cell reads the spans of the traced calls
    ctx.trace.device.append((0.0, 1.0, "a device operation", "kernel"))
    summary = program_spans.summary(ctx)
    runs = [s["count"] for name, s in summary.items() if name in program_spans.ENTRIES]
    assert runs == [ctx.traced_calls]
    for name in names:
        value = harness.reader(ROOT, name)(ctx)
        assert value is not None and value >= 0, name
    layers = [k for k in summary if k not in program_spans.ENTRIES]
    assert harness.reader(ROOT, "prelude_ms")(ctx) == pytest.approx(
        summary["cloudsc2.prelude"]["self_ms"] / ctx.traced_calls)
    # the entry's own time is what no layer covers
    total = sum(summary[k]["self_ms"] for k in layers)
    entry = next(summary[k] for k in program_spans.ENTRIES if k in summary)
    assert total == pytest.approx(entry["device_ms"] - entry["self_ms"])

    # a program without spans (the parent commit): nothing, and no error
    monkeypatch.setitem(sys.modules, "cloudsc2jax_torch.spans", None)
    ctx.trace.host = [h for h in ctx.trace.host if not h[2].startswith("cloudsc2.")]
    for name in names:
        assert harness.reader(ROOT, name)(ctx) is None, name


def test_launches_counted_inside_the_entry_ranges(tmp_path):
    events = [("user_annotation", "bench.window", 0, 100),
              ("user_annotation", "cloudsc2.run_nl", 1, 40),
              ("cuda_runtime", "cudaLaunchKernel", 2, 3),
              ("cuda_runtime", "cudaLaunchKernel", 10, 6),
              ("cuda_driver", "cuLaunchKernel", 11, 2),  # made by the one above
              ("cuda_runtime", "cudaMemsetAsync", 20, 1),
              ("cuda_runtime", "cudaEventRecord", 22, 1),
              ("cuda_driver", "cuLaunchKernel", 30, 1),  # a library's own launch
              ("cuda_runtime", "cudaLaunchKernel", 50, 1),  # outside the call
              ("user_annotation", "cloudsc2.run_nl", 60, 20),
              ("cuda_runtime", "cudaLaunchKernel", 61, 1),
              ("kernel", "void cloudsc2_nl_kernel<float>", 5, 30)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": t, "dur": d} for c, n, t, d in events]}))
    ctx = SimpleNamespace(trace=trace.read(path, "bench.window"), traced_calls=2)
    assert program_spans.launches(ctx) == 5
    assert harness.reader(ROOT, "launches_per_call")(ctx) == 2.5
    # no device trace: nothing
    assert harness.reader(ROOT, "launches_per_call")(
        SimpleNamespace(trace=None, traced_calls=0)) is None
