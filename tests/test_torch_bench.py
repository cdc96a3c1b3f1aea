"""The port's benchmark entry point, ``python -m cloudsc2jax_torch.bench``,
on the CPU: one JSON line per variant with the JAX bench's record and the
port's own fields, bytes counted from the tensors, and no fall back when a
card is asked for and missing.  The plain versions run at 100 columns and
9 levels; the numbers are no measurement of anything."""

import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from cloudsc2jax_torch import bench
from cloudsc2jax_torch.state import Cloudsc2State

ROOT = pathlib.Path(__file__).resolve().parents[1]
NLEV = 9

COMMON = {"metric", "value", "unit", "vs_baseline", "ngptot", "nlev", "platform",
          "baseline", "vs_measured_xla_cpu_f64", "device_name", "power_limit_w",
          "note"}
KEYS = {
    "nl": COMMON | {"ms_per_call", "bytes_accessed_gb", "attained_gbps"},
    "tlad": COMMON | {"ms_per_call", "bytes_accessed_gb", "attained_gbps"},
    "chunked": COMMON | {"mesh_columns_per_second", "chunk", "mesh_devices",
                         "ms_per_pass", "ms_per_chunk", "streamed_gb",
                         "peak_allocated_gb", "device_memory_gb"},
}
KEYS["chunked_tlad"] = KEYS["chunked"]
METRIC = {"nl": "nl_columns_per_second_streams_cpu",
          "tlad": "tlad_columns_per_second_streams_cpu",
          "chunked": "nl_columns_per_second_chunked_cpu",
          "chunked_tlad": "tlad_columns_per_second_chunked_cpu"}


def _env(monkeypatch, variant, checks="0"):
    for k, v in {"CLOUDSC2_BENCH_VARIANT": variant, "CLOUDSC2_BENCH_NGPTOT": "100",
                 "CLOUDSC2_BENCH_REPEATS": "1",
                 "CLOUDSC2_BENCH_F32_CHECKS": checks}.items():
        monkeypatch.setenv(k, v)


def _stream_bytes(ncol, inputs, outputs):
    """f32 bytes of ``inputs`` level streams plus paph, and ``outputs``
    level streams."""
    return ((inputs * NLEV + 1) + outputs * NLEV) * ncol * 4


@pytest.mark.parametrize("variant", ["nl", "tlad", "chunked", "chunked_tlad"])
def test_bench_prints_one_record(monkeypatch, capsys, variant):
    """Each variant prints one JSON line with the record's keys; the bytes
    of a call (a chunk) are its inputs read once and its results written
    once: 15 level streams + paph in and 8 out for nl, 16 + paph in and
    8 + 8 + 16 (paph's adjoint one row more) out for tlad with primal."""
    _env(monkeypatch, variant)
    record = bench.main(["--device", "cpu", "--nlev", str(NLEV)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == record
    assert set(record) == KEYS[variant]
    assert record["metric"] == METRIC[variant]
    assert record["unit"] == "columns/s/chip" and record["platform"] == "cpu"
    assert record["value"] > 0 and math.isfinite(record["value"])
    assert record["vs_baseline"] == record["value"] / bench.BASELINE_COLS_PER_S
    assert record["device_name"] is None and record["nlev"] == NLEV
    tlad = variant.endswith("tlad")
    expected = _stream_bytes(record.get("chunk", 100), 16 if tlad else 15,
                             8 + 8 + 16 if tlad else 8) + (4 * record.get("chunk", 100)
                                                           if tlad else 0)
    if variant.startswith("chunked"):
        assert record["ngptot"] == record["chunk"] == 128  # one 128-column group
        assert record["mesh_devices"] == 1
        assert record["peak_allocated_gb"] is None
        assert record["streamed_gb"] * 1e9 == pytest.approx(expected, rel=1e-12)
    else:
        assert record["ngptot"] == 100
        assert record["bytes_accessed_gb"] * 1e9 == pytest.approx(expected, rel=1e-12)


def test_bench_f32_verdicts(monkeypatch):
    """The tlad record's f32 verdicts: the CLI's measurement at
    min(ngptot, 16384) columns with each tolerance's margin."""
    st = Cloudsc2State.synthetic(ngptot=100, nlev=NLEV)
    fv = bench.f32_verdicts(st, 100, torch.device("cpu"))
    assert fv["ngptot"] == 100 and fv["finite"] is True
    assert fv["ad_identity_rel_err"] < fv["ad_identity_tol"]
    assert fv["ad_identity_margin"] == round(
        fv["ad_identity_tol"] / fv["ad_identity_rel_err"], 1)
    assert fv["margin_ok"] == (fv["tl_parity_margin"] >= 4.0
                               and fv["ad_identity_margin"] >= 4.0)


def test_bench_module_runs(tmp_path):
    """``python -m cloudsc2jax_torch.bench`` prints exactly one line on
    standard output, a JSON record."""
    env = {**os.environ, "CLOUDSC2_BENCH_VARIANT": "chunked",
           "CLOUDSC2_BENCH_NGPTOT": "100", "CLOUDSC2_BENCH_REPEATS": "1",
           "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-m", "cloudsc2jax_torch.bench", "--device", "cpu",
         "--nlev", "5"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr
    (line,) = proc.stdout.strip().splitlines()
    assert json.loads(line)["metric"] == METRIC["chunked"]


@pytest.mark.parametrize("argv,variant", [(["--device", "cuda"], "nl"),
                                          (["--device", "cpu"], "headline")])
def test_bench_refuses(monkeypatch, capsys, argv, variant):
    """No fall back: ``--device cuda`` without a card, or an unknown
    variant, exits non-zero and prints no record."""
    if torch.cuda.is_available() and "cuda" in argv:
        pytest.skip("a card is present")
    _env(monkeypatch, variant)
    with pytest.raises(SystemExit) as exc:
        bench.main(argv)
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""
