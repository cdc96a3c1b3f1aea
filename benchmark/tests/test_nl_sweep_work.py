"""``benchmark/nl_sweep_work.py``, the work of the NL sweep's launch in a
call, and the readers of the NL sweep's metrics (``nl_sweep_roofline_pct``,
``nl_warps_per_sm``).

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness, nl_sweep_work, program_spans, roofline

from .conftest import ROOT

READERS = ("nl_sweep_roofline_pct", "nl_warps_per_sm")


def _cell(name):
    _, _, config, traffic = harness.load_cell(ROOT, name)
    return config, traffic


def test_values_are_the_hand_count():
    config, _ = _cell("nl.stream")
    nlev, ncol = 137, 327_680
    # 14 level streams, paph one row more, ceta and zscalm a level,
    # ztrpaus and paph_sfc a column; the 8 outputs
    read = 14 * nlev * ncol + (nlev + 1) * ncol + 2 * nlev + 2 * ncol
    assert nl_sweep_work.values(config) == (read, 8 * nlev * ncol)


def test_streams_are_the_launchers_argument_lists():
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as km

    prelude = {"ceta", "zscalm", "ztrpaus", "paph_sfc"}
    level = set(km.KERNEL_STREAMS) - prelude - {"paph"}
    assert len(km.KERNEL_STREAMS) == len(set(km.KERNEL_STREAMS)) == 14 + 1 + len(prelude)
    assert prelude < set(km.KERNEL_STREAMS) and "pqs" not in level and len(level) == 14
    assert len(km.KERNEL_OUTPUTS) == 8


def test_float64_moves_twice_the_bytes_of_float32():
    config, _ = _cell("nl.stream")
    f64, _ = _cell("nl.f64")
    assert config["dtype"] == "float32" and f64["dtype"] == "float64"
    b32, ops32 = nl_sweep_work.sweep_work(config)
    b64, ops64 = nl_sweep_work.sweep_work(f64)
    assert b64 == 2 * b32 and ops64 == ops32 == 363 * 137 * 327_680
    assert b32 == 4_134_011_976  # 4.134 GB
    # bytes bind in both precisions (ms)
    least32 = nl_sweep_work.least_time_s(config) * 1e3
    least64 = nl_sweep_work.least_time_s(f64) * 1e3
    assert least32 == pytest.approx(1.2340, abs=1e-4)
    assert least64 == pytest.approx(2 * least32)
    assert ops64 / roofline.PEAK_FLOPS["float64"] * 1e3 < least64
    # the whole call's work of roofline.py, less the prelude's four
    call_bytes, _ = roofline.call_work(config, _cell("nl.stream")[1])
    assert b32 - call_bytes == 4 * (2 * 137 + 2 * 327_680)


def test_the_tlad_unit_is_refused():
    config, _ = _cell("tlad.noprim")
    with pytest.raises(ValueError, match="nonlinear"):
        nl_sweep_work.values(config)


def _ctx(cell, trace=True):
    config, traffic = _cell(cell)
    tr = SimpleNamespace(device=[(0.0, 1.0, "a kernel", "kernel")]) if trace else None
    return SimpleNamespace(config=config, traffic=traffic, trace=tr,
                           traced_calls=2 if trace else 0)


@pytest.mark.parametrize("cell", ("nl.f64", "nl.stream"))
def test_readers_read_the_sweep_span(monkeypatch, cell):
    summary = {"cloudsc2.nl_sweep": {"self_ms": 8.0, "counters": {"blocks_per_sm": 6.0}},
               "cloudsc2.prelude": {"self_ms": 0.1, "counters": {}}}
    monkeypatch.setattr(program_spans, "summary", lambda ctx: summary)
    ctx = _ctx(cell)
    read = {name: harness.reader(ROOT, name) for name in READERS}
    want = 100.0 * nl_sweep_work.least_time_s(ctx.config) * 1e3 / 4.0  # per traced call
    assert read["nl_sweep_roofline_pct"](ctx) == pytest.approx(want)
    assert read["nl_warps_per_sm"](ctx) == 24.0
    # a program whose NL span carries no counters (the parent commit): no
    # warps, and the roofline share all the same
    del summary["cloudsc2.nl_sweep"]["counters"]
    assert read["nl_warps_per_sm"](ctx) is None
    assert read["nl_sweep_roofline_pct"](ctx) == pytest.approx(want)
    # no NL span at all: nothing
    del summary["cloudsc2.nl_sweep"]
    assert all(read[name](ctx) is None for name in READERS)


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_a_device_trace(name):
    assert harness.reader(ROOT, name)(_ctx("nl.f64", trace=False)) is None
