"""The evaporating TL+AD configuration ``cloudsc2-tlad-evap-f32`` (YOPHNC
LEVAPLS2 on, cloudsc2.F90:556-591) on the CPU: its file and its cell, the
evaporation acting on the benchmark's columns, the port's evaporating f32
unit against the benchmark's float64 reference with every copy of a stored
column bit for bit its first, :func:`cloudsc2jax_torch.ops.power` that makes
those copies exact, the sweeps' spans naming the body they ran, the reader
of ``tl_warps_per_sm`` and the CLI's ``--levapls2``.

The file imports neither JAX nor ``conftest``::

    python -m pytest tests/test_torch_evap.py -q -p no:cacheprovider --noconftest
"""

import dataclasses
import json
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cloudsc2jax_torch import cli, drivers, ops, spans
from cloudsc2jax_torch.state import Cloudsc2State

ROOT = Path(__file__).resolve().parents[1]
CONFIG = "cloudsc2-tlad-evap-f32"
CELL = "tlad.evap"
P = spans.PREFIX
# the benchmark's CPU size (benchmark/tests/conftest.py): 40 columns tiled
# from 12 stored columns of 20 levels
NCOL, STORED, NLEV = 40, 12, 20


def _config(name: str) -> dict:
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def test_the_configuration_is_the_f32_unit_with_evaporation():
    """The file is ``cloudsc2-tlad-f32``'s but for its name, its text, the
    switch, the operations counted with evaporation on and the calibrated
    limits; its one cell runs the ``noprim`` traffic on one card."""
    evap, base = _config(CONFIG), _config("cloudsc2-tlad-f32")
    differ = {k for k in evap.keys() | base.keys() if evap.get(k) != base.get(k)}
    assert differ <= {"name", "source", "deployment", "assumed", "levapls2",
                      "ops_per_column_level", "tolerance", "limits"}
    assert "levapls2" in differ and evap["name"] == CONFIG and evap["levapls2"] is True
    assert base["levapls2"] is False and evap["ldrain1d"] is False
    assert evap["reduced"] == [] and evap["dtype"] == "float32"
    assert (evap["klev"], evap["ngptot"]) == (137, 327_680)
    assert evap["limits"]["copies"] == 0.0
    assert set(evap["assumed"]) >= {"levapls2", "ops_per_column_level", "tolerance", "limits"}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (entry,) = [c for c in bench["configs"] if c["name"] == CONFIG]
    assert entry["file"] == f"benchmark/configs/{CONFIG}.json"
    assert entry["source"] == evap["source"] and entry["reduced"] == []
    (cell,) = [w for w in bench["workloads"] if w["config"] == CONFIG]
    assert (cell["name"], cell["traffic"], cell["chips"]) == (CELL, "noprim", 1)


def test_evaporation_acts_on_the_benchmarks_columns():
    """Seed 1's stored columns (100 x 137): with LEVAPLS2 on the reference's
    precipitation cover is positive in at least a tenth of the
    column-levels (19.2% when written); off, nowhere."""
    from benchmark import data
    from benchmark.reference import physics

    share = {}
    for on in (False, True):
        c = physics.consts(3600.0, on)
        s = data.make_sets(1, 1, nlon=100, nlev=137, c=c, dtype=torch.float32, pqs=False)[0]
        out = physics.nl({k: v.double().T for k, v in s.items()}, data.ceta(s), c)
        share[on] = float((out["pcovptot"] > 0).double().mean())
    assert share[False] == 0.0
    assert share[True] >= 0.1


@pytest.fixture(scope="module")
def unit():
    """The port's evaporating unit on the ``noprim`` traffic's stream
    contract in float32 (its plain versions, through the benchmark's
    adapter), on 40 columns tiled from 12 stored ones, and the benchmark's
    float64 reference of the stored columns: ``(config, outputs, ref)``."""
    from benchmark import data, fields
    from benchmark.adapters import port_units
    from benchmark.reference import physics

    config = {**_config(CONFIG), "klev": NLEV, "stored_columns": STORED, "ngptot": NCOL}
    traffic = json.loads((ROOT / "benchmark" / "workloads" / "noprim.json").read_text())
    c = physics.consts(config["ptsphy"], config["levapls2"])
    stored = data.make_sets(2**31 + 77, 1, nlon=STORED, nlev=NLEV, c=c,
                            dtype=torch.float32, pqs=True)[0]
    ceta = data.ceta(stored)
    x = port_units.inputs(data.tile(stored, NCOL, torch.device("cpu")), config, traffic)
    call = port_units.entry(port_units.params(c, ceta, config), config, traffic)
    out = port_units.outputs(call(x), config, traffic)
    ref = physics.tlad({k: v.double().T for k, v in stored.items()}, ceta, c,
                       dscale=config["dscale"], lregcl=config["lregcl"],
                       ldrain1d=config["ldrain1d"])
    names = fields.expected("tlad", "stream", traffic["write_primal"])
    return config, out, fields.reference_fields(ref, names)


def test_every_copy_of_a_stored_column_is_its_first_bit_for_bit(unit):
    """Every output of the evaporating f32 unit at a copy of a stored column
    equals the one at its first copy, bit for bit (before ``ops.power`` the
    copies at positions 24-39 read an ulp off those at 0-11)."""
    _, out, _ = unit
    first = torch.arange(NCOL) % STORED
    for name, v in out.items():
        assert v.shape[1] == NCOL
        assert torch.equal(v, v[:, first]), name


def test_the_evaporating_unit_matches_the_reference(unit):
    """The port's tangents and adjoints against the float64 reference at the
    configuration's tolerance: no column off, no copy differing; and the
    evaporation's own tangent is not zero there."""
    from benchmark import compare

    config, out, ref = unit
    readings = compare.call_readings(out, ref, torch.arange(NCOL), config["tolerance"])
    correct, checks = compare.verdict(readings, config["limits"])
    assert correct, checks
    assert readings["tangent"] == readings["adjoint"] == readings["copies"] == 0.0
    assert float(ref["d_pcovptot"].abs().max()) > 0.0


@pytest.mark.parametrize("n", [40, 64, 100])
def test_power_is_the_same_at_every_position(n):
    """``n`` equal float32 values raised to a non-integer power give ``n``
    equal values, tangents and cotangents, each the float64 power rounded
    once; float64 tensors get ``x ** e`` itself (the level bodies' traces)."""
    x = torch.full((n,), 3.7e-3, dtype=torch.float32)
    y, dy = torch.func.jvp(lambda v: ops.power(v, 0.5777), (x,), (torch.ones_like(x),))
    _, vjp = torch.func.vjp(lambda v: ops.power(v, 0.5777), x)
    (g,) = vjp(torch.ones_like(x))
    for v in (y, dy, g):
        assert v.dtype == torch.float32
        assert torch.equal(v, v[:1].expand(n))
    assert y[0] == (x[0].double() ** 0.5777).float()
    x64 = torch.rand(n, dtype=torch.float64)
    assert torch.equal(ops.power(x64, 0.5777), x64 ** 0.5777)


def _stub_launches(monkeypatch):
    """The NL, TL (both builds) and AD launchers with their launches, checks
    and occupancy stubbed: no card is needed."""
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as kmod
    from cloudsc2jax_torch.kernels import tlad_kernel as tk

    st = Cloudsc2State.synthetic(ngptot=6, nlev=5)
    x = st.device_kernel_inputs(6, dtype=torch.float32, device="cpu", pqs=True)
    pre = kmod.plain_prelude(x, st.params)
    monkeypatch.setattr(build, "occupancy", lambda *a: {"blocks_per_sm": 3})
    monkeypatch.setattr(build, "launch", lambda *a, **k: None)
    monkeypatch.setattr(kmod, "_load_kernel", lambda: "nl library")
    monkeypatch.setattr(kmod, "_launch", lambda *a, **k: [torch.empty_like(x.pt)] * 8)
    monkeypatch.setattr(tk, "_library", lambda name, flags=(): name)
    monkeypatch.setattr(tk, "_tl_launch", lambda *a, **k: (None, None, ()))
    monkeypatch.setattr(tk, "_check_launch", lambda *a: None)
    monkeypatch.setattr(tk, "_ad_operands", lambda *a: [])
    monkeypatch.setattr(tk, "_param_array", lambda *a: "params")

    def launches(levapls2: bool, ldrain1d: bool):
        p = st.params.replace(yophnc=dataclasses.replace(st.params.yophnc,
                                                         levapls2=levapls2))
        kmod.launch_cloudsc2_nl(x, pre, p, ldrain1d=ldrain1d)
        tk.launch_cloudsc2_tl(x, pre, p, dscale=0.01, ldrain1d=ldrain1d,
                              write_primal=False)
        tk.launch_cloudsc2_tl_std(x, pre, p, dscale=0.01, ldrain1d=ldrain1d)
        tk.launch_cloudsc2_ad(x, pre, None, (), p, ldrain1d=ldrain1d)

    return launches


@pytest.mark.parametrize("levapls2,ldrain1d", [(False, False), (True, False), (False, True)])
def test_the_sweeps_spans_name_the_body_they_ran(monkeypatch, levapls2, ldrain1d):
    """Each sweep's span carries ``evap``: 1 where LEVAPLS2 or LDRAIN1D made
    the launch run the evaporating body; the AD's also ``stash_slots``, the
    ``kStashSlots`` the header states for its body (148 with evaporation,
    87 without); nothing is asked with the profiler off."""
    launches = _stub_launches(monkeypatch)
    spans.clear()
    launches(levapls2, ldrain1d)
    assert spans.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        launches(levapls2, ldrain1d)
    counters = {n[len(P):]: s["counters"] for n, s in spans.summary().items()}
    evap = int(levapls2 or ldrain1d)
    assert {n: c["evap"] for n, c in counters.items()} == {
        "nl_sweep": evap, "tl_sweep": evap, "ad_sweep": evap}
    header = (ROOT / "cloudsc2jax_torch/csrc/cloudsc2_ad_level.cuh").read_text()
    body = re.search(rf"struct Level<{str(bool(evap)).lower()}, true> {{(.*?)\n}};",
                     header, re.S).group(1)
    slots = int(re.search(r"kStashSlots = (\d+);", body).group(1))
    assert counters["ad_sweep"]["stash_slots"] == slots == (148 if evap else 87)
    assert all("stash_slots" not in counters[n] for n in ("nl_sweep", "tl_sweep"))


def test_tl_warps_per_sm_reads_the_tl_spans_blocks(monkeypatch):
    """``tl_warps_per_sm``: the ``tl_sweep`` span's ``blocks_per_sm`` times
    the 4 warps of a block; nothing where the span has no such counter (a
    program without span counters) or the run no device trace."""
    from benchmark import harness, program_spans

    read = harness.reader(ROOT, "tl_warps_per_sm")
    ctx = SimpleNamespace(trace=SimpleNamespace(device=[(0.0, 1.0, "k", "kernel")]),
                          traced_calls=2)
    summary = {P + "tl_sweep": {"self_ms": 8.0, "counters": {"blocks_per_sm": 8.0}},
               P + "ad_sweep": {"self_ms": 9.0, "counters": {"blocks_per_sm": 3.0}}}
    monkeypatch.setattr(program_spans, "summary", lambda c: summary)
    assert read(ctx) == 32.0
    del summary[P + "tl_sweep"]["counters"]
    assert read(ctx) is None
    monkeypatch.undo()
    assert read(SimpleNamespace(trace=None, traced_calls=0)) is None


def test_the_clis_levapls2_reaches_the_run(monkeypatch):
    """``--levapls2`` switches YOPHNC LEVAPLS2 on for the run (off without
    it): ``tlad --kernels`` on the CPU's plain versions hands the drivers
    params with it on, and the adjoint identity holds."""
    seen = []
    real = drivers.run_tlad

    def spy(*args, **kw):
        seen.append(kw["params"].yophnc.levapls2)
        return real(*args, **kw)

    monkeypatch.setattr(drivers, "run_tlad", spy)
    assert cli._build_parser().parse_args(["tlad"]).levapls2 is False
    rc = cli.main(["tlad", "1", "12", "12", "--device", "cpu", "--kernels", "--levapls2"])
    assert rc == 0
    assert seen and all(seen)
