"""The port's spans (:mod:`cloudsc2jax_torch.spans`): nothing recorded with
the profiler off; under ``torch.profiler`` each layer of ``run_nl`` and
``run_tlad`` is a ``cloudsc2.*`` range of the Chrome trace and a record
with its call, parent and self time; the store is bounded; the CLI's
``--profile`` prints the spans' table and their counters; on the CPU only
the ``contract`` span carries counters (its form and bytes), the
``nl_sweep`` span none on either contract.  On a card (marked ``cuda``):
the NL sweep's span against the profiler's kernel time, the layers' self
times against the entry span, and the counters of the NL, TL and AD sweeps'
spans against the compiler's report and the card's limits, in f32 and f64,
for both contracts' units, beside the counters of their warps' stamps
where the call stamped.

The file imports neither JAX nor ``conftest``; the CPU cases run the plain
versions on a synthetic store of 13 levels::

    python -m pytest tests/test_torch_spans.py -q -p no:cacheprovider --noconftest
"""

import io
import json
import re

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
    ("run_tlad", "kernels"): {"run_tlad", "levels_major", "prelude", "tl_sweep",
                              "contract", "ad_sweep"},
}


@pytest.fixture(scope="module")
def small():
    return Cloudsc2State.synthetic(ngptot=24, nlev=13)


def _body_counts(kind, evap, lregcl=True):
    """What the generated header of ``kind`` ("tl" or "ad") states for its
    body ``Level<evap, lregcl>``: ``kDivides``, ``kReciprocals`` and, in the
    AD, ``kStashSlots``, under the span counters' names."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    header = (root / f"cloudsc2jax_torch/csrc/cloudsc2_{kind}_level.cuh").read_text()
    flags = f"{str(bool(evap)).lower()}, {str(bool(lregcl)).lower()}"
    body = re.search(rf"struct Level<{flags}> {{(.*?)\n}};", header, re.S).group(1)
    names = (("divides", "Divides"), ("reciprocals", "Reciprocals"))
    if kind == "ad":
        names += (("stash_slots", "StashSlots"),)
    return {name: int(re.search(rf"k{key} = (\d+);", body).group(1))
            for name, key in names}


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


def test_counters_go_to_the_innermost_span_and_the_summary_means_them():
    rec = spans.Recorder()
    like = torch.zeros(1)
    for blocks in (5, 2):
        with rec.span("run_tlad", like):
            with rec.span("ad_sweep", like):
                rec.count(lambda: {"dtype": 32, "blocks_per_sm": blocks})
                rec.count(lambda: {"registers": 95})
    rec.count(lambda: {"registers": 1})  # no span open: nothing
    summary = rec.summary()
    assert summary[P + "ad_sweep"]["counters"] == {"dtype": 32, "blocks_per_sm": 3.5,
                                                   "registers": 95}
    assert summary[P + "run_tlad"]["counters"] == {}
    assert rec.summary(calls=1)[P + "ad_sweep"]["counters"]["blocks_per_sm"] == 2


def test_no_counters_on_the_cpu_or_with_the_profiler_off(small):
    asked = []
    spans.count(lambda: asked.append(1) or {"registers": 1})
    assert asked == []  # off: not even asked for
    call = _call(small, "run_tlad", "streams")
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    # the plain versions launch no kernel instance
    assert all(r.counters is None for r in spans.records())
    assert {n: s["counters"] for n, s in spans.summary().items()} == {
        P + n: {} for n in EXPECTED["run_tlad", "streams"]}


@pytest.mark.parametrize("backend", ("streams", "kernels"))
def test_the_nl_sweep_span_carries_no_counters_on_the_cpu(small, backend, monkeypatch):
    """``run_nl``'s plain sweep launches no kernel instance: its
    ``nl_sweep`` span carries no counters, and with the profiler off the
    one reader of the sweeps' counters is not asked."""
    from cloudsc2jax_torch.kernels import build

    asked = []
    monkeypatch.setattr(build, "occupancy", lambda *a: asked.append(a) or {})
    call = _call(small, "run_nl", backend)
    call()
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    assert asked == []
    summary = spans.summary()
    assert summary[P + "nl_sweep"]["count"] == 1
    assert summary[P + "nl_sweep"]["counters"] == {}
    assert all(r.counters is None for r in spans.records() if r.name == P + "nl_sweep")


@pytest.mark.parametrize("lregcl", [False, True])
@pytest.mark.parametrize("ldrain1d", [False, True])
def test_the_ad_span_counts_its_body_divisions(small, monkeypatch, ldrain1d, lregcl):
    """The ``ad_sweep`` span of a launch of the AD kernel carries
    ``divides``, ``reciprocals`` and ``stash_slots``: the ``kDivides``,
    ``kReciprocals`` and ``kStashSlots`` that the generated header states
    for the body ``Level<evap, lregcl>`` the launch runs, beside the
    instance's counters and ``evap``; with the profiler off nothing is
    read.  No card is needed: the launch itself is stubbed."""
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import tlad_kernel as tk
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import plain_prelude

    x = small.device_kernel_inputs(6, dtype=torch.float64, device="cpu", pqs=True)
    pre = plain_prelude(x, small.params)
    asked = []
    monkeypatch.setattr(build, "occupancy",
                        lambda *a: asked.append(a[3:]) or {"blocks_per_sm": 5})
    monkeypatch.setattr(build, "launch", lambda *a, **k: None)
    monkeypatch.setattr(tk, "_library", lambda name, flags=(): name)
    monkeypatch.setattr(tk, "_check_launch", lambda *a: None)
    monkeypatch.setattr(tk, "_ad_operands", lambda *a: [])
    monkeypatch.setattr(tk, "_param_array", lambda *a: "params")

    def launch():
        tk.launch_cloudsc2_ad(x, pre, None, (), small.params, ldrain1d=ldrain1d,
                              lregcl=lregcl)

    launch()
    assert asked == []
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        launch()
    assert asked == [(int(ldrain1d), int(lregcl))]
    want = _body_counts("ad", ldrain1d, lregcl)
    assert 0 < want["reciprocals"] < want["divides"] < want["stash_slots"]
    assert spans.summary()[P + "ad_sweep"]["counters"] == {
        "blocks_per_sm": 5, "evap": int(ldrain1d), **want}


@pytest.mark.parametrize("launch", ["tl", "tl_std", "tl_din"])
@pytest.mark.parametrize("lregcl", [False, True])
@pytest.mark.parametrize("ldrain1d", [False, True])
def test_the_tl_span_counts_its_body_divisions(small, monkeypatch, ldrain1d, lregcl,
                                               launch):
    """The ``tl_sweep`` span of a launch of a TL kernel (the stream
    contract's, the standard contract's build without FMA contraction, the
    streamed-increment drop-in's) carries ``divides`` and ``reciprocals``:
    the ``kDivides`` and ``kReciprocals`` that the generated TL header
    states for the body ``Level<evap, lregcl>`` the launch runs, beside
    ``evap`` and, where the library reports one, the instance's counters;
    with the profiler off nothing is read.  No card is needed: the launch
    itself is stubbed."""
    from cloudsc2jax_torch.kernels import build
    from cloudsc2jax_torch.kernels import tlad_kernel as tk
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import plain_prelude

    x = small.device_kernel_inputs(6, dtype=torch.float64, device="cpu", pqs=True)
    pre = plain_prelude(x, small.params)
    asked = []
    monkeypatch.setattr(build, "occupancy",
                        lambda *a: asked.append(a[3:]) or {"blocks_per_sm": 8})
    monkeypatch.setattr(tk, "_library", lambda name, flags=(): name)
    monkeypatch.setattr(tk, "_tl_launch", lambda *a, **k: (None, None, ()))
    monkeypatch.setattr(tk, "_tl_din_launch", lambda *a, **k: (None, None))
    run = {"tl": lambda: tk.launch_cloudsc2_tl(x, pre, small.params, dscale=0.01,
                                               ldrain1d=ldrain1d, lregcl=lregcl,
                                               write_primal=False),
           "tl_std": lambda: tk.launch_cloudsc2_tl_std(x, pre, small.params, dscale=0.01,
                                                       ldrain1d=ldrain1d, lregcl=lregcl),
           "tl_din": lambda: tk.launch_cloudsc2_tl_din(x, x, pre, small.params,
                                                       ldrain1d=ldrain1d, lregcl=lregcl)}
    spans.clear()
    run[launch]()
    assert asked == [] and spans.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        run[launch]()
    want = _body_counts("tl", ldrain1d, lregcl)
    assert 0 < want["reciprocals"] < want["divides"]
    instance = {"tl": {"blocks_per_sm": 8}, "tl_std": {"blocks_per_sm": 8, "checkpoints": 1},
                "tl_din": {}}[launch]
    assert spans.summary()[P + "tl_sweep"]["counters"] == {
        **instance, "evap": int(ldrain1d), **want}


def test_the_contract_span_counts_its_form_and_bytes(small):
    """The ``contract`` span carries ``in_place`` and ``bytes``: 1 on the
    standard paths, whose sweeps write into the contract's flux fields (the
    unit's two assemblies, the tangent's with the seeds), 0 for
    ``unblock_outputs`` of streams it did not allocate; on the CPU the bytes
    of the plain passes (``contract_bytes``)."""
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import contract_bytes, unblock_outputs

    def plain(in_place, seeds):
        return contract_bytes(13, 24, 4, in_place=in_place, seeds=seeds, kernel=False)

    streams = _call(small, "run_nl", "streams")()
    want = {("run_nl", "kernels"): (1, [plain(True, False)]),
            ("run_tlad", "kernels"): (1, [plain(True, False), plain(True, True)]),
            ("unblock_outputs", None): (0, [plain(False, False)])}
    for (entry, backend), (in_place, moved) in want.items():
        call = (_call(small, entry, backend) if backend else
                lambda: unblock_outputs(streams, small.params))
        spans.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            call()
        contract = spans.summary()[P + "contract"]
        assert contract["count"] == len(moved), entry
        assert contract["counters"] == {"in_place": in_place,
                                        "bytes": sum(moved) / len(moved)}, entry


def test_the_spans_table_prints_the_counters():
    row = {"count": 2, "device_ms": 4.0, "self_ms": 4.0, "host_ms": 0.1}
    summary = {P + "run_tlad": {**row, "self_ms": 0.0, "counters": {}},
               P + "ad_sweep": {**row, "counters": {"dtype": 64.0, "blocks_per_sm": 2.0}}}
    buf = io.StringIO()
    cli.print_spans(summary, buf)
    lines = buf.getvalue().splitlines()
    assert lines[0].split()[-1] == "counters"
    rows = {line.split()[0]: line.split()[5:] for line in lines[1:]}
    assert rows == {P + "ad_sweep": ["dtype=64", "blocks_per_sm=2"], P + "run_tlad": []}


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


# the stream contract's unit in f32 and f64, one profiled call each (the
# profiler's CPU activity alone: the spans record, and the card is not
# traced a second time in the process), then the compiler's report of the
# two libraries
_COUNTERS_ON_THE_CARD = """
import json, torch
from torch.profiler import ProfilerActivity, profile
from cloudsc2jax_torch import drivers, spans
from cloudsc2jax_torch.kernels import build
from cloudsc2jax_torch.state import Cloudsc2State
st = Cloudsc2State.synthetic(ngptot=100, nlev=137)
got = {}
for dtype in (torch.float32, torch.float64):
    x = st.device_kernel_inputs(16_384, dtype=dtype, device="cuda", pqs=True)
    drivers.run_tlad(x, st.params, write_primal=False)
    torch.cuda.synchronize()
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        drivers.run_tlad(x, st.params, write_primal=False)
        torch.cuda.synchronize()
    got[str(dtype)] = {name: s["counters"] for name, s in spans.summary().items()}
got["ptxas"] = {lib: build.ptxas_report(lib) for lib in ("cloudsc2_tl", "cloudsc2_ad")}
got["sm"] = {k: getattr(torch.cuda.get_device_properties(0), k) for k in (
    "regs_per_multiprocessor", "max_threads_per_multi_processor",
    "shared_memory_per_multiprocessor", "shared_memory_per_block_optin")}
print(json.dumps(got))
"""


# the counters a sweep's span gets from its warps' stamps (spans.stamp_counters)
STAMPS = ("fill_pct", "kernel_ms", "tail_ms", "sms")


def _instance(counters: dict) -> dict:
    """A card's sweep span's counters of the shipped instance: without its
    warps' stamps and the twin's occupancy (``twin_*``), which a span of
    the first recorded call carries (spans.STAMP_EVERY)."""
    return {k: v for k, v in counters.items()
            if k not in STAMPS and not k.startswith("twin_")}


def _blocks_per_sm(registers: int, shared_bytes: int, sm: dict) -> int:
    """Blocks of 128 threads an SM of compute capability 9.0 holds: its
    registers (allocated per warp in units of 256), its threads, and its
    shared memory (each block reserves 1 KB beside its own), at most 32."""
    per_warp = -(-registers * 32 // 256) * 256
    by_registers = sm["regs_per_multiprocessor"] // per_warp // 4
    by_threads = sm["max_threads_per_multi_processor"] // 128
    by_shared = (sm["shared_memory_per_multiprocessor"] // (shared_bytes + 1024)
                 if shared_bytes else 32)
    return min(by_registers, by_threads, by_shared, 32)


@pytest.mark.cuda
def test_sweep_counters_on_the_card():
    """The ``tl_sweep`` and ``ad_sweep`` spans of the stream contract's unit
    carry the instance they launched, in f32 and f64: registers and local
    bytes as ptxas reports them, the AD body's shared-memory slots, and the
    blocks an SM holds at them; the f32 AD at least its budget's 5; both
    ``evap`` 0; each its body's divisions and reciprocals, the AD's also
    its shared slots, as the headers state them."""
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _COUNTERS_ON_THE_CARD], capture_output=True,
                         text=True, timeout=900, cwd=root)
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    ad_body, tl_body = _body_counts("ad", False), _body_counts("tl", False)
    slots = ad_body["stash_slots"]
    for dtype, code, size in (("torch.float32", "f", 4), ("torch.float64", "d", 8)):
        for span, lib, entry, shared in (
                ("tl_sweep", "cloudsc2_tl", f"cloudsc2_tl_kernelI{code}Lb0ELb1ELb0E", 0),
                ("ad_sweep", "cloudsc2_ad", f"cloudsc2_ad_kernelI{code}Lb0ELb1E",
                 slots * 128 * size)):
            counters = got[dtype][P + span]
            (ptxas,) = [e for e in got["ptxas"][lib] if entry in e["entry"]]
            body = ad_body if span == "ad_sweep" else tl_body
            assert _instance(counters) == {
                "dtype": 8 * size, "registers": ptxas["registers"],
                "local_bytes": ptxas["stack_bytes"], "shared_bytes": shared,
                "blocks_per_sm": _blocks_per_sm(ptxas["registers"], shared, got["sm"]),
                "evap": 0, **body,
            }, (dtype, span, ptxas, got["sm"])
        assert set(got[dtype]) == {P + n for n in EXPECTED["run_tlad", "streams"]}
    assert got["torch.float32"][P + "ad_sweep"]["blocks_per_sm"] >= 5


# the stream contract's unit in f32 with LEVAPLS2 on, one profiled call, as
# above: the evaporating instances of both libraries
_EVAP_COUNTERS_ON_THE_CARD = """
import dataclasses, json, torch
from torch.profiler import ProfilerActivity, profile
from cloudsc2jax_torch import drivers, spans
from cloudsc2jax_torch.kernels import build
from cloudsc2jax_torch.state import Cloudsc2State
st = Cloudsc2State.synthetic(ngptot=100, nlev=137)
p = st.params.replace(yophnc=dataclasses.replace(st.params.yophnc, levapls2=True))
x = st.device_kernel_inputs(16_384, dtype=torch.float32, device="cuda", pqs=True)
drivers.run_tlad(x, p, write_primal=False)
torch.cuda.synchronize()
spans.clear()
with profile(activities=[ProfilerActivity.CPU]):
    drivers.run_tlad(x, p, write_primal=False)
    torch.cuda.synchronize()
got = {name: s["counters"] for name, s in spans.summary().items()}
got["ptxas"] = {lib: build.ptxas_report(lib) for lib in ("cloudsc2_tl", "cloudsc2_ad")}
got["sm"] = {k: getattr(torch.cuda.get_device_properties(0), k) for k in (
    "regs_per_multiprocessor", "max_threads_per_multi_processor",
    "shared_memory_per_multiprocessor", "shared_memory_per_block_optin")}
print(json.dumps(got))
"""


@pytest.mark.cuda
def test_evaporating_sweep_counters_on_the_card():
    """With LEVAPLS2 on, the ``tl_sweep`` and ``ad_sweep`` spans of the
    stream contract's f32 unit carry the evaporating instances
    (``Level<true, true>``): ``evap`` 1, registers and local bytes as ptxas
    reports them, the AD body's ``kStashSlots`` (148) as its shared slots and
    ``stash_slots``, each body's divisions and reciprocals as the headers
    state them, and the blocks an SM holds at them: the AD's shared memory
    leaves it 3, below the 5 of the body without evaporation."""
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _EVAP_COUNTERS_ON_THE_CARD],
                         capture_output=True, text=True, timeout=900, cwd=root)
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    ad_body, tl_body = _body_counts("ad", True), _body_counts("tl", True)
    slots = ad_body["stash_slots"]
    assert slots == 148
    for span, lib, entry, shared in (
            ("tl_sweep", "cloudsc2_tl", "cloudsc2_tl_kernelIfLb1ELb1ELb0E", 0),
            ("ad_sweep", "cloudsc2_ad", "cloudsc2_ad_kernelIfLb1ELb1E", slots * 128 * 4)):
        (ptxas,) = [e for e in got["ptxas"][lib] if entry in e["entry"]]
        body = ad_body if span == "ad_sweep" else tl_body
        assert _instance(got[P + span]) == {
            "dtype": 32, "registers": ptxas["registers"],
            "local_bytes": ptxas["stack_bytes"], "shared_bytes": shared,
            "blocks_per_sm": _blocks_per_sm(ptxas["registers"], shared, got["sm"]),
            "evap": 1, **body,
        }, (span, ptxas, got["sm"])
    assert got[P + "ad_sweep"]["blocks_per_sm"] == 3


# the standard contract's unit in f32 and f64, one profiled call each, as
# above, then the compiler's report of its TL library
_STD_COUNTERS_ON_THE_CARD = """
import json, torch
from torch.profiler import ProfilerActivity, profile
from cloudsc2jax_torch import drivers, spans
from cloudsc2jax_torch.kernels import build
from cloudsc2jax_torch.state import Cloudsc2State
st = Cloudsc2State.synthetic(ngptot=100, nlev=137)
got = {}
for dtype in (torch.float32, torch.float64):
    x = st.device_inputs(16_384, dtype=dtype, device="cuda")
    drivers.run_tlad(x, st.params, backend="kernels")
    torch.cuda.synchronize()
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        drivers.run_tlad(x, st.params, backend="kernels")
        torch.cuda.synchronize()
    got[str(dtype)] = {name: s["counters"] for name, s in spans.summary().items()}
got["ptxas"] = build.ptxas_report("cloudsc2_tl", (), build.NO_FMA)
got["sm"] = {k: getattr(torch.cuda.get_device_properties(0), k) for k in (
    "regs_per_multiprocessor", "max_threads_per_multi_processor",
    "shared_memory_per_multiprocessor", "shared_memory_per_block_optin")}
print(json.dumps(got))
"""


@pytest.mark.cuda
def test_standard_unit_tl_counters_on_the_card():
    """The ``tl_sweep`` span of ``run_tlad(backend="kernels")`` carries the
    instance of the standard contract's TL it launched, in f32 and f64
    (registers and local bytes as ptxas reports them for the build of
    ``cloudsc2_tl`` with ``build.NO_FMA``, the blocks an SM holds at them),
    its body's divisions and reciprocals as the TL header states them, and
    ``checkpoints`` 1: the same launch wrote the reverse sweep's carries,
    and no ``fwd_sweep`` span ran."""
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _STD_COUNTERS_ON_THE_CARD],
                         capture_output=True, text=True, timeout=900, cwd=root)
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    for dtype, code, size in (("torch.float32", "f", 4), ("torch.float64", "d", 8)):
        counters = got[dtype][P + "tl_sweep"]
        (ptxas,) = [e for e in got["ptxas"]
                    if f"cloudsc2_tl_kernelI{code}Lb0ELb1ELb1E" in e["entry"]]
        assert _instance(counters) == {
            "dtype": 8 * size, "registers": ptxas["registers"],
            "local_bytes": ptxas["stack_bytes"], "shared_bytes": 0,
            "blocks_per_sm": _blocks_per_sm(ptxas["registers"], 0, got["sm"]),
            "evap": 0, **_body_counts("tl", False), "checkpoints": 1,
        }, (dtype, ptxas, got["sm"])
        assert set(got[dtype]) == {P + n for n in EXPECTED["run_tlad", "kernels"]}


# run_nl on the stream contract in f32 and f64, one profiled call each (the
# profiler's CPU activity alone, as above), then the compiler's report of
# the NL library
_NL_COUNTERS_ON_THE_CARD = """
import json, torch
from torch.profiler import ProfilerActivity, profile
from cloudsc2jax_torch import drivers, spans
from cloudsc2jax_torch.kernels import build
from cloudsc2jax_torch.state import Cloudsc2State
st = Cloudsc2State.synthetic(ngptot=100, nlev=137)
got = {}
for dtype in (torch.float32, torch.float64):
    x = st.device_kernel_inputs(16_384, dtype=dtype, device="cuda")
    drivers.run_nl(x, st.params)
    torch.cuda.synchronize()
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        drivers.run_nl(x, st.params)
        torch.cuda.synchronize()
    got[str(dtype)] = {name: s["counters"] for name, s in spans.summary().items()}
got["ptxas"] = build.ptxas_report("cloudsc2_nl")
got["sm"] = {k: getattr(torch.cuda.get_device_properties(0), k) for k in (
    "regs_per_multiprocessor", "max_threads_per_multi_processor",
    "shared_memory_per_multiprocessor", "shared_memory_per_block_optin")}
print(json.dumps(got))
"""


@pytest.mark.cuda
def test_nl_sweep_counters_on_the_card():
    """The ``nl_sweep`` span of ``run_nl`` carries the instance it
    launched, in f32 and f64: registers and local bytes as ptxas reports
    them for ``cloudsc2_nl_kernel``, no shared memory, and the blocks an SM
    holds at them; no other span carries counters."""
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _NL_COUNTERS_ON_THE_CARD],
                         capture_output=True, text=True, timeout=900, cwd=root)
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    for dtype, code, size in (("torch.float32", "f", 4), ("torch.float64", "d", 8)):
        (ptxas,) = [e for e in got["ptxas"] if f"cloudsc2_nl_kernelI{code}Lb0E" in e["entry"]]
        assert _instance(got[dtype][P + "nl_sweep"]) == {
            "dtype": 8 * size, "registers": ptxas["registers"],
            "local_bytes": ptxas["stack_bytes"], "shared_bytes": 0,
            "blocks_per_sm": _blocks_per_sm(ptxas["registers"], 0, got["sm"]),
            "evap": 0,
        }, (dtype, ptxas, got["sm"])
        assert {n: c for n, c in got[dtype].items() if c} == {
            P + "nl_sweep": got[dtype][P + "nl_sweep"]}
        assert set(got[dtype]) == {P + n for n in EXPECTED["run_nl", "streams"]}
