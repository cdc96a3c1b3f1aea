"""The readers of the sweeps' slot fill (``nl_sweep_fill_pct``,
``tl_sweep_fill_pct``, ``ad_sweep_fill_pct``): the ``fill_pct`` counter of
their sweep's span where a traced run has it, nothing without a device
trace or the counter, and the cells that report each.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from benchmark import harness, program_spans

from .conftest import ROOT

READERS = {"nl_sweep_fill_pct": "nl_sweep", "tl_sweep_fill_pct": "tl_sweep",
           "ad_sweep_fill_pct": "ad_sweep"}


def _ctx(trace=True):
    tr = SimpleNamespace(device=[(0.0, 1.0, "a kernel", "kernel")]) if trace else None
    return SimpleNamespace(trace=tr, traced_calls=2 if trace else 0)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_nothing_without_a_device_trace(name):
    assert harness.reader(ROOT, name)(_ctx(trace=False)) is None


@pytest.mark.parametrize("name,sweep", READERS.items())
def test_a_reader_reads_its_sweeps_fill(monkeypatch, name, sweep):
    summary = {f"cloudsc2.{s}": {"self_ms": 4.0, "counters": {
        "blocks_per_sm": 8.0, "fill_pct": 80.0 + i, "kernel_ms": 2.0}}
        for i, s in enumerate(READERS.values())}
    monkeypatch.setattr(program_spans, "summary", lambda ctx: summary)
    read = harness.reader(ROOT, name)
    assert read(_ctx()) == summary[f"cloudsc2.{sweep}"]["counters"]["fill_pct"]
    # a program whose sweeps stamp no warps (the parent commit): nothing
    del summary[f"cloudsc2.{sweep}"]["counters"]["fill_pct"]
    assert read(_ctx()) is None
    del summary[f"cloudsc2.{sweep}"]
    assert read(_ctx()) is None


def test_each_fill_is_reported_where_its_sweep_runs():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {m["name"]: m["workloads"] for m in bench["per_layer"] if m["name"] in READERS}
    tlad = ["tlad.noprim", "tlad.standard", "tlad.primal", "tlad.f64", "tlad.evap"]
    assert cells == {"nl_sweep_fill_pct": ["nl.stream", "nl.standard", "nl.f64"],
                     "tl_sweep_fill_pct": tlad, "ad_sweep_fill_pct": tlad}
    configs = {w["name"]: w["config"] for w in bench["workloads"]}
    for name, workloads in cells.items():
        assert all(("-nl-" in configs[w]) == name.startswith("nl_") for w in workloads)
