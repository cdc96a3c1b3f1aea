"""The port's spans (:mod:`cloudsc2jax_torch.spans`): nothing recorded with
the profiler off; under ``torch.profiler`` each layer of ``run_nl`` and
``run_tlad`` is a ``cloudsc2.*`` range of the Chrome trace and a record
with its call, parent and self time; the store is bounded; the CLI's
``--profile`` prints the spans' table.  On a card (marked ``cuda``): the NL
sweep's span against the profiler's kernel time, and the layers' self
times against the entry span.

The file imports neither JAX nor ``conftest``; the CPU cases run the plain
versions on a synthetic store of 13 levels::

    python -m pytest tests/test_torch_spans.py -q -p no:cacheprovider --noconftest
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cloudsc2jax_torch import cli, drivers, spans
from cloudsc2jax_torch.state import Cloudsc2State

P = spans.PREFIX
# the ranges of one call, per entry and backend
EXPECTED = {
    ("run_nl", "streams"): {"run_nl", "prelude", "nl_sweep"},
    ("run_nl", "kernels"): {"run_nl", "levels_major", "prelude", "nl_sweep", "contract"},
    ("run_tlad", "streams"): {"run_tlad", "prelude", "tl_sweep", "ad_sweep"},
    ("run_tlad", "kernels"): {"run_tlad", "levels_major", "increments", "prelude",
                              "tl_sweep", "contract", "fwd_sweep", "ad_sweep"},
}


@pytest.fixture(scope="module")
def small():
    return Cloudsc2State.synthetic(ngptot=24, nlev=13)


def _call(st, entry, backend, device="cpu", ncol=24):
    if backend == "streams":
        x = st.device_kernel_inputs(ncol, dtype=torch.float32, device=device,
                                    pqs=entry == "run_tlad")
    else:
        x = st.device_inputs(ncol, dtype=torch.float32, device=device)
    return lambda: getattr(drivers, entry)(x, st.params, backend=backend)


def test_off_records_nothing_and_enters_no_range(small, monkeypatch):
    def refuse(*_):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = len(spans.records())
    for entry, backend in EXPECTED:
        _call(small, entry, backend)()
    assert len(spans.records()) == before
    # one shared no-op context, nothing allocated per span
    like = torch.zeros(1)
    assert spans.span("prelude", like) is spans.span("run_nl", like)


@pytest.mark.parametrize("entry,backend", list(EXPECTED))
def test_ranges_and_records_of_a_profiled_call(small, tmp_path, entry, backend):
    call = _call(small, entry, backend)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
        call()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation" and e["name"].startswith(P)}
    want = {P + n for n in EXPECTED[entry, backend]}
    assert names == want

    recs = spans.records()
    assert {r.name for r in recs} == want
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == [P + entry] * 2
    assert roots[0].call != roots[1].call
    for r in recs:
        root = r
        while root.parent is not None:
            root = by_id[root.parent]
        assert root.name == P + entry and r.call == root.call
        assert r.card is None and r.device_ms >= 0 and r.host_ns > 0
    # self time: the duration less what the span's children cover
    summary = spans.summary()
    for name in want:
        mine = [r for r in recs if r.name == name]
        children = sum(c.device_ms for c in recs if by_id.get(c.parent) in mine)
        assert summary[name]["count"] == len(mine)
        assert summary[name]["self_ms"] == pytest.approx(
            sum(r.device_ms for r in mine) - children, abs=1e-9)
    # the layers cover the call: little is left in the entry's own time
    run = summary[P + entry]
    assert run["self_ms"] < 0.5 * run["device_ms"]
    # the last call alone
    assert spans.summary(1)[P + entry]["count"] == 1


def test_store_is_bounded_and_a_span_does_not_nest_in_itself():
    rec = spans.Recorder(cap=5)
    like = torch.zeros(1)
    for _ in range(4):
        with rec.span("run_nl", like):
            with rec.span("prelude", like):
                with rec.span("prelude", like):
                    pass
    recs = rec.records()
    assert len(recs) == 5
    # the oldest went first: the last 5 of 4 calls' prelude and run_nl
    assert [r.name for r in recs] == [P + "run_nl"] + [P + "prelude", P + "run_nl"] * 2
    assert [r.call for r in recs] == [1, 2, 2, 3, 3] and recs[0].id == 2
    assert [r.call for r in rec.records(calls=1)] == [3, 3]
    rec.clear()
    assert rec.records() == []


def test_cli_profile_prints_the_spans_table(tmp_path, capsys):
    rc = cli.main(["nl", "1", "10", "10", "--device", "cpu", "--no-validate",
                   "--kernels", "--profile", str(tmp_path / "prof")])
    assert rc == 0
    err = capsys.readouterr().err.splitlines()
    head = next(i for i, line in enumerate(err) if "self ms/call" in line)
    rows = {line.split()[0]: line.split()[1:] for line in err[head + 1:]
            if line.strip().startswith(P)}
    assert set(rows) == {P + "run_nl", P + "prelude", P + "nl_sweep"}
    assert rows[P + "run_nl"][0] == "1"
    assert sum(float(r[3]) for r in rows.values()) == pytest.approx(100.0, abs=0.05)


# the card's case runs in a process of its own: a second torch.profiler
# session with CUDA activity in one process may trace no device operation
# (seen with a later test's --profile on the card); and the profiler may
# drop a kernel's record now and then, so kernels are compared by their mean.
# A span's events time the device, idle or not: the first calls after a
# drained device wait for the host, so the spans are read in the last 10 of
# 20 calls, when the host runs ahead
_ON_THE_CARD = """
import json, torch
from torch.profiler import ProfilerActivity, profile
from cloudsc2jax_torch import drivers, spans
from cloudsc2jax_torch.state import Cloudsc2State
st = Cloudsc2State.synthetic(ngptot=100, nlev=137)
x = st.device_kernel_inputs(327_680, dtype=torch.float32, device="cuda")
for _ in range(3):
    drivers.run_nl(x, st.params)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(20):
        drivers.run_nl(x, st.params)
    torch.cuda.synchronize()
kernels = [e for e in prof.key_averages() if "cloudsc2_nl_kernel" in e.key]
print(json.dumps({"kernel_ms": sum(e.device_time_total for e in kernels) * 1e-3,
                  "kernels": sum(e.count for e in kernels), "summary": spans.summary(10),
                  "cards": sorted({r.card for r in spans.records()})}))
"""


@pytest.mark.cuda
def test_spans_on_the_card_against_the_profiler():
    """At 327,680 columns: the NL sweep's span within 5% of the profiler's
    ``cloudsc2_nl_kernel`` time (each a mean over the launches it saw), and
    the layers' self times within 3% of the ``run_nl`` span."""
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run([sys.executable, "-c", _ON_THE_CARD], capture_output=True,
                         text=True, timeout=600, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    summary = got["summary"]
    sweep = summary[P + "nl_sweep"]
    assert sweep["count"] == 10 and got["cards"] == [0]
    assert 1 <= got["kernels"] <= 20
    assert sweep["self_ms"] / 10 == pytest.approx(got["kernel_ms"] / got["kernels"],
                                                  rel=0.05), got["kernels"]
    run = summary[P + "run_nl"]
    layers = sum(s["self_ms"] for name, s in summary.items() if name != P + "run_nl")
    assert layers == pytest.approx(run["device_ms"], rel=0.03)
