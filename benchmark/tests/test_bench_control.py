"""``correct`` has to come out false for the control and for each fault a
cell can have: the whole run is driven on the CPU, past the look for a card,
with the timed path broken underneath.

* the control: the reference one precision below the configuration's, in
  the system's place (``adapters/control_bf16.py``);
* ``stale``: a call that returns the results of the call before (its
  state unchanged);
* ``half``: half of the columns left out, the mean over the rest in their
  place;
* ``altered``: one value of one field altered where it is produced.

The cells run on one card, so there is no exchange between cards to leave
out.
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.adapters import port_units

from .conftest import NGPTOT

CELLS = ("nl.stream", "nl.standard", "tlad.noprim", "tlad.standard")


def small_run(root, workload, **kw):
    return harness.run(workload, 2**31 + 77, 0.2, False, t_start=time.perf_counter(),
                       root=root, device="cpu", ngptot=NGPTOT, **kw)


@pytest.mark.parametrize("workload", ("nl.stream", "tlad.noprim"))
def test_control_is_not_correct(small_root, workload):
    result, checks, _ = small_run(small_root, workload, adapter="control_bf16")
    assert not result["correct"], checks
    assert min(checks[k]["value"] for k in checks if k != "copies") > 0.5
    assert checks["copies"]["value"] == 0.0  # the control is tiled like the program


def _broken(fault, entry):
    def make(p, config, traffic):
        call = entry(p, config, traffic)
        previous = []

        def broken(x):
            res = call(x)
            out = port_units.outputs(res, config, traffic)
            if fault == "stale":
                previous.append(res)
                return previous[-2] if len(previous) > 1 else res
            if fault == "half":
                for v in out.values():
                    half = v.shape[1] // 2
                    v[:, half:] = v[:, :half].mean(dim=1, keepdim=True)
            if fault == "altered":
                v = next(iter(out.values()))
                v[v.shape[0] // 2, 0] += 0.01 * v.abs().max()
            return res

        return broken

    return make


@pytest.mark.parametrize("fault", ("stale", "half", "altered"))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(small_root, monkeypatch, workload, fault):
    monkeypatch.setattr(port_units, "entry", _broken(fault, port_units.entry))
    result, checks, _ = small_run(small_root, workload)
    assert not result["correct"], checks


def test_the_unbroken_path_is_correct(small_root):
    result, checks, _ = small_run(small_root, "tlad.noprim")
    assert result["correct"], checks
    assert all(torch.isfinite(torch.tensor(c["value"])) for c in checks.values())
