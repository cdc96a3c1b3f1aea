"""The float64 cell ``nl.f64`` on the CPU at the conftest's small size:
the unbroken path is ``correct``; the control one precision below
(``adapters/control_f32.py``), each fault a cell can have, and the port's
own float32 NL path on the same inputs are not.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.adapters import port_units

from .test_bench_control import _broken, small_run

CELL = "nl.f64"


def test_the_cell_is_the_float64_configuration(small_root):
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    config = json.loads((small_root / "benchmark/configs/cloudsc2-nl-f64.json").read_text())
    f32 = json.loads((small_root / "benchmark/configs/cloudsc2-nl-f32.json").read_text())
    assert cell["config"] == config["name"] and cell["traffic"] == "stream"
    assert cell["chips"] == 1
    assert config["dtype"] == "float64" and config["reduced"] == []
    # every physics setting of the float32 configuration
    for key in ("klev", "ngptot", "stored_columns", "ptsphy", "levapls2", "ldrain1d",
                "ops_per_column_level", "unit", "adapter"):
        assert config[key] == f32[key], key
    # far below what float32 can hold (~1e-7 of a value)
    assert config["tolerance"] < 1e-8
    assert config["limits"]["copies"] == 0.0


def test_the_unbroken_path_is_correct(small_root):
    result, checks, _ = small_run(small_root, CELL)
    assert result["correct"], checks
    assert set(checks) == {"primal", "copies"}
    assert all(c["value"] == 0.0 for c in checks.values()), checks


def test_the_float32_control_is_not_correct(small_root):
    result, checks, _ = small_run(small_root, CELL, adapter="control_f32")
    assert not result["correct"], checks
    assert checks["primal"]["value"] >= 0.5, checks
    assert checks["copies"]["value"] == 0.0  # the control is tiled like the program


@pytest.mark.parametrize("fault", ("stale", "half", "altered"))
def test_fault_is_not_correct(small_root, monkeypatch, fault):
    monkeypatch.setattr(port_units, "entry", _broken(fault, port_units.entry))
    result, checks, _ = small_run(small_root, CELL)
    assert not result["correct"], checks


def test_the_ports_float32_path_fails_the_float64_tolerance(small_root, monkeypatch):
    """The same inputs, rounded to float32 on their way in: the port's f32
    NL sweep, held to the float64 reference at the cell's tolerance."""
    real = port_units.inputs

    def in_float32(tiled, config, traffic):
        return real({k: v.float() for k, v in tiled.items()}, config, traffic)

    monkeypatch.setattr(port_units, "inputs", in_float32)
    seen = []
    entry = port_units.entry

    def spy(p, config, traffic):
        call = entry(p, config, traffic)
        return lambda x: (seen.append(x.pt.dtype), call(x))[1]

    monkeypatch.setattr(port_units, "entry", spy)
    result, checks, _ = small_run(small_root, CELL)
    assert set(seen) == {torch.float32}
    assert not result["correct"], checks
    assert checks["primal"]["value"] >= 0.5, checks
