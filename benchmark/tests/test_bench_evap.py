"""The evaporating cell ``tlad.evap`` (``cloudsc2-tlad-evap-f32``, LEVAPLS2
on) on the CPU at the conftest's small size: the unbroken path is
``correct``, its copies exact; the control one precision below
(``adapters/control_bf16.py``), each fault a cell can have, and the port
with the evaporation switched off, held to this configuration's reference,
are not: the comparison sees the mechanism.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json

import pytest

from benchmark.adapters import port_units

from .test_bench_control import _broken, small_run

CELL = "tlad.evap"


def test_the_cell_is_the_evaporating_configuration(small_root):
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    config = json.loads(
        (small_root / "benchmark/configs/cloudsc2-tlad-evap-f32.json").read_text())
    assert cell["config"] == config["name"] and cell["traffic"] == "noprim"
    assert cell["chips"] == 1
    assert config["levapls2"] is True and config["dtype"] == "float32"
    assert config["reduced"] == []


def test_the_unbroken_path_is_correct(small_root):
    result, checks, _ = small_run(small_root, CELL)
    assert result["correct"], checks
    assert set(checks) == {"tangent", "adjoint", "copies"}
    assert checks["copies"]["value"] == 0.0


def test_the_bfloat16_control_is_not_correct(small_root):
    result, checks, _ = small_run(small_root, CELL, adapter="control_bf16")
    assert not result["correct"], checks
    assert min(checks[k]["value"] for k in ("tangent", "adjoint")) >= 0.5, checks
    assert checks["copies"]["value"] == 0.0  # the control is tiled like the program


@pytest.mark.parametrize("fault", ("stale", "half", "altered"))
def test_fault_is_not_correct(small_root, monkeypatch, fault):
    monkeypatch.setattr(port_units, "entry", _broken(fault, port_units.entry))
    result, checks, _ = small_run(small_root, CELL)
    assert not result["correct"], checks


def test_the_port_without_evaporation_is_not_correct(small_root, monkeypatch):
    """The same inputs through the port with LEVAPLS2 off, held to the
    evaporating reference at the cell's tolerance."""
    real = port_units.params
    seen = []

    def without_evaporation(c, ceta, config):
        p = real(c, ceta, {**config, "levapls2": False})
        seen.append(p.yophnc.levapls2)
        return p

    monkeypatch.setattr(port_units, "params", without_evaporation)
    result, checks, _ = small_run(small_root, CELL)
    assert seen == [False]
    assert not result["correct"], checks
    assert min(checks[k]["value"] for k in ("tangent", "adjoint")) >= 0.5, checks
