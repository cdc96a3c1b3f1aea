"""``benchmark/sweep_work.py``, the work each sweep's launch does in a call
of the TL+AD unit, and the readers of the per-sweep metrics
(``tl_sweep_roofline_pct``, ``ad_sweep_roofline_pct``, ``ad_warps_per_sm``).

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness, program_spans, sweep_work

from .conftest import ROOT

READERS = ("tl_sweep_roofline_pct", "ad_sweep_roofline_pct", "ad_warps_per_sm")


def _cell(name):
    _, _, config, traffic = harness.load_cell(ROOT, name)
    return config, traffic


def test_values_are_the_hand_count():
    config, traffic = _cell("tlad.noprim")
    nlev, ncol = 137, 327_680
    # the 16 inputs (paph one row more), ztrpaus and paph_sfc a column,
    # ceta and zscalm a level
    inputs = (16 * nlev + 1) * ncol
    prelude = 2 * ncol + 2 * nlev
    assert sweep_work.values("tl_sweep", config, traffic) == (
        inputs + prelude, (8 + 3) * nlev * ncol)  # 8 tangents, 3 checkpoints
    assert sweep_work.values("ad_sweep", config, traffic) == (
        inputs + prelude + (3 + 8) * nlev * ncol, inputs)  # + checkpoints, seeds
    # with the primal streams, the TL writes 8 more
    primal_config, primal = _cell("tlad.primal")
    assert sweep_work.values("tl_sweep", primal_config, primal)[1] == 19 * nlev * ncol


def test_streams_are_the_launchers_argument_lists():
    from cloudsc2jax_torch.kernels import tlad_kernel as tk

    prelude = {"ceta", "zscalm", "ztrpaus", "paph_sfc"}
    assert len(tk.TL_STREAMS) == 16 + len(prelude) and prelude < set(tk.TL_STREAMS)
    assert len(tk.TL_OUTPUTS) == 8 + 3 + 8
    assert len(tk.AD_STREAMS) == 16 + len(prelude) + 3 + 8
    assert len(tk.AD_OUTPUTS) == 16


def test_float64_moves_twice_the_bytes_of_float32():
    config, traffic = _cell("tlad.noprim")
    f64, _ = _cell("tlad.f64")
    assert config["dtype"] == "float32" and f64["dtype"] == "float64"
    for sweep in sweep_work.SWEEPS:
        b32, ops32 = sweep_work.sweep_work(sweep, config, traffic)
        b64, ops64 = sweep_work.sweep_work(sweep, f64, traffic)
        assert b64 == 2 * b32 and ops64 == ops32
    # bytes bind both sweeps in both precisions (ms)
    least = {(s, c["dtype"]): sweep_work.least_time_s(s, c, traffic) * 1e3
             for s in sweep_work.SWEEPS for c in (config, f64)}
    assert least[("tl_sweep", "float32")] == pytest.approx(1.4485, abs=1e-4)
    assert least[("ad_sweep", "float32")] == pytest.approx(2.3065, abs=1e-4)
    assert least[("tl_sweep", "float64")] == pytest.approx(2 * least[("tl_sweep", "float32")])
    assert least[("ad_sweep", "float64")] == pytest.approx(2 * least[("ad_sweep", "float32")])


def test_the_standard_contract_is_refused():
    config, traffic = _cell("tlad.standard")
    with pytest.raises(ValueError, match="stream contract"):
        sweep_work.values("tl_sweep", config, traffic)


def test_frozen_operations_are_the_count():
    got = sweep_work.count_ops()
    assert {k: round(v) for k, v in got.items()} == sweep_work.OPS_PER_COLUMN_LEVEL


def _ctx(cell, trace=True):
    config, traffic = _cell(cell)
    tr = SimpleNamespace(device=[(0.0, 1.0, "a kernel", "kernel")]) if trace else None
    return SimpleNamespace(config=config, traffic=traffic, trace=tr,
                           traced_calls=2 if trace else 0)


@pytest.mark.parametrize("cell", ("tlad.f64", "tlad.noprim"))
def test_readers_read_the_sweep_spans(monkeypatch, cell):
    summary = {"cloudsc2.tl_sweep": {"self_ms": 8.0, "counters": {"blocks_per_sm": 8.0}},
               "cloudsc2.ad_sweep": {"self_ms": 20.0, "counters": {"blocks_per_sm": 5.0}}}
    monkeypatch.setattr(program_spans, "summary", lambda ctx: summary)
    ctx = _ctx(cell)
    read = {name: harness.reader(ROOT, name) for name in READERS}
    for sweep, ms in (("tl_sweep", 4.0), ("ad_sweep", 10.0)):  # per traced call
        want = 100.0 * sweep_work.least_time_s(sweep, ctx.config, ctx.traffic) * 1e3 / ms
        assert read[f"{sweep}_roofline_pct"](ctx) == pytest.approx(want)
    assert read["ad_warps_per_sm"](ctx) == 20.0
    # a program whose spans carry no counters (the parent commit): no warps
    for s in summary.values():
        del s["counters"]
    assert read["ad_warps_per_sm"](ctx) is None
    assert read["ad_sweep_roofline_pct"](ctx) is not None


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_a_device_trace(name):
    assert harness.reader(ROOT, name)(_ctx("tlad.f64", trace=False)) is None
