"""The bench's modes with a port counterpart (``bench.py:108-191``), on the
CPU at 100 columns and 9 levels: ``CLOUDSC2_BENCH_PALLAS=0`` (the truth
path, ``nl`` and ``tlad``), ``CLOUDSC2_BENCH_MODE=resident`` (kernel #2) and
``CLOUDSC2_BENCH_LAYOUT=standard`` (``run_nl(backend="kernels")``), each a
record naming its implementation; the knobs the port refuses exit non-zero
and print no record.  The numbers are no measurement of anything."""

import json

import pytest

from cloudsc2jax_torch import bench
from cloudsc2jax_torch.kernels import experiments as ex

NLEV = 9
NCOL = 100
KEYS = {"metric", "value", "unit", "vs_baseline", "ngptot", "nlev", "platform",
        "baseline", "vs_measured_xla_cpu_f64", "device_name", "power_limit_w", "note",
        "ms_per_call", "bytes_accessed_gb", "attained_gbps"}
# rows of NCOL f32 values a call reads and writes: the standard contract's 16
# inputs with pqs and 10 outputs (paph and the 4 fluxes nlev+1), the
# resident sweep's 16 levels-major inputs and 8 streams; tlad adds the
# tangent (10) and the 16 adjoints
STANDARD_ROWS = (16 * NLEV + 1) + (6 * NLEV + 4 * (NLEV + 1))
ROWS = {
    ("nl", "truth"): STANDARD_ROWS,
    ("tlad", "truth"): STANDARD_ROWS + (6 * NLEV + 4 * (NLEV + 1)) + (16 * NLEV + 1),
    ("nl", "resident"): (16 * NLEV + 1) + 8 * NLEV,
    ("nl", "kernels"): STANDARD_ROWS,
}
MODES = [("nl", {"CLOUDSC2_BENCH_PALLAS": "0"}, "truth"),
         ("tlad", {"CLOUDSC2_BENCH_PALLAS": "0"}, "truth"),
         ("nl", {"CLOUDSC2_BENCH_MODE": "resident"}, "resident"),
         ("nl", {"CLOUDSC2_BENCH_LAYOUT": "standard"}, "kernels")]


def _env(monkeypatch, variant, knobs):
    for k, v in {"CLOUDSC2_BENCH_VARIANT": variant, "CLOUDSC2_BENCH_NGPTOT": str(NCOL),
                 "CLOUDSC2_BENCH_REPEATS": "1", "CLOUDSC2_BENCH_F32_CHECKS": "0",
                 **knobs}.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("variant,knobs,impl", MODES)
def test_bench_mode_record(monkeypatch, capsys, variant, knobs, impl):
    calls = []
    resident = ex.cloudsc2_nl_resident
    monkeypatch.setattr(ex, "cloudsc2_nl_resident",
                        lambda *a, **k: calls.append(1) or resident(*a, **k))
    _env(monkeypatch, variant, knobs)
    record = bench.main(["--device", "cpu", "--nlev", str(NLEV)])
    (line,) = capsys.readouterr().out.strip().splitlines()
    assert json.loads(line) == record and set(record) == KEYS
    assert record["metric"] == f"{variant}_columns_per_second_{impl}_cpu"
    assert record["ngptot"] == NCOL and record["value"] > 0
    assert record["bytes_accessed_gb"] * 1e9 == pytest.approx(
        ROWS[variant, impl] * NCOL * 4, rel=1e-12)
    # one warm-up call, one timed, one to count the bytes
    assert len(calls) == (3 if impl == "resident" else 0)


@pytest.mark.parametrize("variant,knobs", [
    ("nl", {"CLOUDSC2_BENCH_FUSE_SATUR": "0"}),
    ("nl", {"CLOUDSC2_BENCH_SUBLANES": "64"}),
    ("nl", {"CLOUDSC2_BENCH_MODE": "chunk"}),
    ("nl", {"CLOUDSC2_BENCH_MODE": "resident", "CLOUDSC2_BENCH_LAYOUT": "standard"}),
    ("tlad", {"CLOUDSC2_BENCH_MODE": "resident"}),
    ("tlad", {"CLOUDSC2_BENCH_LAYOUT": "standard"}),
])
def test_bench_refuses_knobs(monkeypatch, capsys, variant, knobs):
    _env(monkeypatch, variant, knobs)
    with pytest.raises(SystemExit) as exc:
        bench.main(["--device", "cpu", "--nlev", str(NLEV)])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""
