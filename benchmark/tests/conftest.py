"""A small copy of the benchmark for the CPU: the same cells, metrics and
code, at a size the plain versions run in seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

# the CPU's sizes: few levels and stored columns, short traced parts
SMALL_CONFIG = {"klev": 20, "stored_columns": 12}
SMALL_TRAFFIC = {"pool_sets": 2, "warmup_calls": 2, "sample_within": 2,
                 "sample_columns": 16, "trace_calls": 2, "host_calls": 2}
NGPTOT = 40


def small_copy(dst: Path) -> Path:
    """``BENCHMARK.json`` and the benchmark's data files under ``dst``, the
    configurations and traffic mixes shrunk for the CPU."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, dst / "benchmark" / sub)
    for path, small in ((dst / "benchmark" / "configs", SMALL_CONFIG),
                        (dst / "benchmark" / "workloads", SMALL_TRAFFIC)):
        for f in path.glob("*.json"):
            f.write_text(json.dumps({**json.loads(f.read_text()), **small}))
    return dst


@pytest.fixture
def small_root(tmp_path) -> Path:
    return small_copy(tmp_path)
