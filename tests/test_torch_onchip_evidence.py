"""The port's evidence battery (``cloudsc2jax_torch.onchip_evidence``) off
the card, with stub steps, as ``tests/test_onchip_evidence.py`` holds the
JAX harness: step execution, the checkpoint after every step, ``--resume``,
retries, JSON steps, and no record at all from a run without a card."""

import json
import sys

import pytest

from cloudsc2jax_torch import onchip_evidence as oe

PY = sys.executable


@pytest.fixture
def stub_steps(monkeypatch, tmp_path):
    steps = {
        "good_json": ([PY, "-c", "print('{\"attained_gbps\": 500.0, \"platform\": \"gpu\"}')"],
                      {"X": "1"}, 30, "json"),
        "good_text": ([PY, "-c", "print('two: 11.38 ms')"], {}, 30, "text"),
        "bad": ([PY, "-c", "raise SystemExit(7)"], {}, 30, "text"),
    }
    monkeypatch.setattr(oe, "steps", lambda: steps)
    return tmp_path / "evidence.json"


def test_battery_checkpoints_and_resume(stub_steps):
    out = str(stub_steps)
    assert oe.main(["--no-preflight", "--out", out, "--retries", "0"]) == 1
    doc = json.loads(stub_steps.read_text())
    res = doc["results"]
    assert res["good_json"]["ok"] and res["good_json"]["env"] == {"X": "1"}
    assert res["good_json"]["record"] == {"attained_gbps": 500.0, "platform": "gpu"}
    assert res["good_text"]["ok"] and "11.38 ms" in res["good_text"]["stdout_tail"]
    assert not res["bad"]["ok"] and res["bad"]["rc"] == 7
    assert doc["derived"] == {} and doc["updated"] >= doc["started"]
    assert not stub_steps.with_name(stub_steps.name + ".tmp").exists()
    # --resume skips what is ok and runs the failed step again
    assert oe.main(["--no-preflight", "--resume", "--out", out, "--retries", "0"]) == 1
    again = json.loads(stub_steps.read_text())["results"]
    assert again["good_json"]["timestamp"] == res["good_json"]["timestamp"]
    assert again["good_json"]["history"] == res["good_json"]["history"]
    assert len(again["bad"]["history"]) == 1 and again["bad"]["rc"] == 7
    # a subset
    assert oe.main(["--no-preflight", "--steps", "good_text", "--out", out]) == 0


def test_retry_counts():
    rec = oe.run_step("bad", [PY, "-c", "raise SystemExit(1)"], {}, 30, "text",
                      retries=2)
    assert rec["attempts"] == 3 and not rec["ok"]
    assert [h["rc"] for h in rec["history"]] == [1, 1, 1]


def test_time_limit_is_a_failed_attempt():
    rec = oe.run_step("slow", [PY, "-c", "import time; time.sleep(30)"], {}, 1,
                      "text", retries=0)
    assert rec["rc"] == -1 and not rec["ok"] and "TIMEOUT" in rec["stderr_tail"]


def test_json_step_requires_json():
    rec = oe.run_step("j", [PY, "-c", "print('no json')"], {}, 30, "json", retries=0)
    assert rec["rc"] == 0 and not rec["ok"]


def test_cpu_record_is_not_evidence():
    rec = oe.run_step("b", [PY, "-c", "print('{\"value\": 1, \"platform\": \"cpu\"}')"],
                      {}, 30, "json", retries=0)
    assert rec["rc"] == 0 and not rec["ok"]
    assert rec["not_ok_reason"] == "the record reports another platform than gpu"


def test_no_card_is_refused_and_never_recorded(stub_steps, monkeypatch, capsys):
    """Without a card the run stops at its preflight: exit code 2, no step
    run, no file written."""
    monkeypatch.setattr(oe, "preflight", lambda: "no-cuda")
    assert oe.main(["--out", str(stub_steps)]) == 2
    assert not stub_steps.exists()
    assert "no card answers" in capsys.readouterr().err


def test_preflight_sees_no_card_here():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert oe.preflight() == "no-cuda"


def test_list_and_battery(capsys):
    assert oe.main(["--list"]) == 0
    names = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert names == list(oe.steps())
    battery = oe.steps()
    assert {"bench_nl", "bench_tlad", "bench_tlad_noprim", "bench_chunked_tlad",
            "kernel_ab", "probe_stream", "cuda_tests", "cli_nl", "cli_tlad"} <= set(names)
    assert "--kernels" in battery["cli_tlad"][0]
    assert "--noconftest" in battery["cuda_tests"][0]
    # every mix of chip_smoke.py phase 16, plain and compute-weighted
    assert sum(n.startswith("probe_") for n in names) == 1 + 8 + 5
    with pytest.raises(SystemExit):
        oe.main(["--steps", "nope", "--no-preflight"])


def test_derive():
    d = oe.derive({
        "bench_nl": {"record": {"value": 1.3e8}},
        "bench_tlad": {"record": {"value": 2.0e7, "f32_verdicts": {"margin_ok": True}}},
        "bench_tlad_noprim": {"record": {"value": 3.0e7}},
        "probe_nl": {"record": {"attained_gbps": 2700.0}},
        "kernel_ab": {"record": {"configs": {"two": {"ms": 11.4}}}},
    })
    assert d == {"nl_columns_per_second": 1.3e8, "f32_verdicts": {"margin_ok": True},
                 "noprim_speedup_vs_tlad": 1.5, "probe_nl_attained_gbps": 2700.0,
                 "kernel_ab_ms": {"two": 11.4}}
