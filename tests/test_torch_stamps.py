"""The sweeps' warp stamps (``csrc/cloudsc2_stamps.cuh``, ``spans.stamped``,
``spans.Recorder.stamps``, ``spans.stamp_counters``).

On the CPU: the reduction of one launch's records on a hand-worked
timeline; with the profiler off no ring of records and no stamped entry,
with it on the twin's entry and its slice; one recorded call in
``spans.STAMP_EVERY`` stamps, and the summary takes the sweep's times and
shared counters from the others; a slice that later launches overwrote
gives no counters, nor does a span that raised; the generated headers are
read once per body and process.  On a card (marked ``cuda``,
16,384 columns): every stamped twin writes its shipped instance's outputs
bit for bit, one record a warp and nothing past them, each warp within its
span, ``sms`` the card's SMs where the grid fills them, ``kernel_ms``
within the span's device time; the shipped entries' SASS is the parent's;
and a traced call makes no more allocations, copies or synchronises with
the stamps than without them.

The file imports neither JAX nor ``conftest``::

    python -m pytest tests/test_torch_stamps.py -q -p no:cacheprovider --noconftest
"""

import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cloudsc2jax_torch import spans
from cloudsc2jax_torch.kernels import build
from cloudsc2jax_torch.kernels import cloudsc2_kernel as ck
from cloudsc2jax_torch.kernels import tlad_kernel as tk
from cloudsc2jax_torch.state import Cloudsc2State

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASE = 1_760_000_000_000_000_000  # a %globaltimer reading, ns


def _records(warps):
    """(start, end, sm) a warp, as a launch's (n, RECORD) int64 records."""
    return torch.tensor([[start, (end - start) | sm << 32] for start, end, sm in warps],
                        dtype=torch.int64)


def test_the_counters_of_a_two_sm_timeline_with_a_partial_last_wave():
    """Two SMs of two resident warps each: a full first wave of four warps
    over 100 ns, then one warp on SM 1 from 110 to 200 ns.  The slots held
    warps for 4 x 100 + 90 of 2 x 2 x 200 ns: 61.25%; SM 0 ran dry at
    100 ns, 100 ns before the end."""
    stamps = _records([(BASE, BASE + 100, 0), (BASE, BASE + 100, 0),
                       (BASE, BASE + 100, 1), (BASE + 2, BASE + 100, 1),
                       (BASE + 110, BASE + 200, 1)])
    got = spans.stamp_counters(stamps, sms=2, resident_warps=2)
    assert got == pytest.approx({"fill_pct": 100.0 * 488 / 800, "kernel_ms": 200e-6,
                                 "tail_ms": 100e-6, "sms": 2}, rel=1e-12)
    # without the SMs' resident warps, or a kernel that took no time: no fill
    assert "fill_pct" not in spans.stamp_counters(stamps, 2, None)
    assert "fill_pct" not in spans.stamp_counters(_records([(BASE, BASE, 3)]), 2, 2)


def _stamp_on_the_cpu(monkeypatch, ring, every=1):
    """Launches on the CPU stamp, into rings of ``ring`` records, in one
    recorded call of ``every``, on cards of two SMs."""
    monkeypatch.setattr(spans, "STAMPED", ("cpu",))
    monkeypatch.setattr(spans, "STAMP_RING", ring)
    monkeypatch.setattr(spans, "STAMP_EVERY", every)
    monkeypatch.setattr(spans, "_sm_count", lambda device: 2)


@pytest.fixture
def cpu_recorder(monkeypatch):
    """A recorder that stamps every call's launches on the CPU, in place of
    the process's."""
    _stamp_on_the_cpu(monkeypatch, 64)
    rec = spans.Recorder()
    monkeypatch.setattr(spans, "_recorder", rec)
    return rec


def _stub_launches(monkeypatch):
    """The four launchers' libraries, checks and launches stubbed: each
    launch appends its entry and last argument."""
    calls = []
    monkeypatch.setattr(build, "launch", lambda lib, entry, like, *a, **k: calls.append(
        (entry, a[-1])))
    monkeypatch.setattr(build, "occupancy", lambda *a: {"blocks_per_sm": 5})
    monkeypatch.setattr(tk, "_library", lambda name, flags=(): name)
    monkeypatch.setattr(tk, "_check_launch", lambda *a: None)
    monkeypatch.setattr(tk, "_ad_operands", lambda *a: [])
    monkeypatch.setattr(tk, "_param_array", lambda *a: "params")
    monkeypatch.setattr(ck, "_load_kernel", lambda: "cloudsc2_nl")
    return calls


def _launch_all(st, ncol):
    x = st.device_kernel_inputs(ncol, dtype=torch.float64, device="cpu", pqs=True)
    pre = ck.plain_prelude(x, st.params)
    nl = ck.launch_cloudsc2_nl
    # the NL launch checks its device before it launches: stubbed in _launch
    nl(x, pre, st.params)
    tk.launch_cloudsc2_tl(x, pre, st.params, dscale=0.01, write_primal=False)
    tk.launch_cloudsc2_tl_std(x, pre, st.params, dscale=0.01)
    tk.launch_cloudsc2_ad(x, pre, None, (), st.params)


def test_no_ring_and_no_stamped_entry_with_the_profiler_off(cpu_recorder, monkeypatch):
    """With the profiler off the four sweeps launch their shipped entries
    and no ring of records is made; recorded, each launches its twin with a
    slice of one record a warp (128 columns a block, 4 warps), the ring made
    once."""
    calls = _stub_launches(monkeypatch)
    monkeypatch.setattr(ck, "_launch", lambda entry, *a, extra=(), **k: calls.append(
        (entry, extra[-1] if extra else None)) or [None] * 8)
    st = Cloudsc2State.synthetic(ngptot=300, nlev=5)
    _launch_all(st, 300)
    assert [e for e, _ in calls] == ["cloudsc2_nl", "cloudsc2_tl", "cloudsc2_tl",
                                     "cloudsc2_ad"]
    assert cpu_recorder._rings == {}
    calls.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        _launch_all(st, 300)
    assert [e for e, _ in calls] == ["cloudsc2_nl_stamped", "cloudsc2_tl_stamped",
                                     "cloudsc2_tl_stamped", "cloudsc2_ad_stamped"]
    ring, head = cpu_recorder._rings[torch.device("cpu")]
    assert all(s.shape == (12, spans.RECORD) for _, s in calls)  # 3 blocks of 4 warps
    assert [s.data_ptr() for _, s in calls] == [
        ring[12 * i:].data_ptr() for i in range(4)]
    assert head == 48 and len(cpu_recorder._rings) == 1


def test_an_overwritten_slice_and_a_span_that_raised_give_no_stamp_counters(monkeypatch):
    """A ring of 8 records and launches of 3 warps: a span that raised
    keeps no slice (records 0-2); the next launches take records 3-5, then,
    not fitting before the ring's end, 0-2, then 3-5 again, over the
    first, which then carries no stamp counters; the other two do."""
    _stamp_on_the_cpu(monkeypatch, 8)
    cpu_recorder = spans.Recorder()
    like = torch.zeros(1)
    timeline = [(BASE, BASE + 100, 0), (BASE, BASE + 50, 1), (BASE + 60, BASE + 90, 1)]
    with pytest.raises(RuntimeError):
        with cpu_recorder.span("raised", like):
            cpu_recorder.stamps(like, 3, 1)
            raise RuntimeError("a refused launch")
    for i in range(3):
        with cpu_recorder.span(f"sweep{i}", like):
            cpu_recorder.count(lambda: {"twin_blocks_per_sm": 1})
            cpu_recorder.stamps(like, 3, 1).copy_(_records(timeline))
    got = {r.name: r.counters for r in cpu_recorder.records()}
    assert got[spans.PREFIX + "sweep0"] == {"twin_blocks_per_sm": 1}
    want = {"twin_blocks_per_sm": 1, "kernel_ms": 100e-6, "tail_ms": 10e-6, "sms": 2,
            "fill_pct": 100.0 * 180 / 200}
    for name in ("sweep1", "sweep2"):
        assert got[spans.PREFIX + name] == pytest.approx(want, rel=1e-12)
    assert got[spans.PREFIX + "raised"] is None


def test_one_recorded_call_in_stamp_every_stamps(cpu_recorder, monkeypatch):
    """With ``STAMP_EVERY`` 8, of 17 recorded AD launches (each its own
    call) the first, the ninth and the seventeenth launch the twin; the
    others the shipped entry, with no slice of the ring."""
    monkeypatch.setattr(spans, "STAMP_EVERY", 8)
    calls = _stub_launches(monkeypatch)
    st = Cloudsc2State.synthetic(ngptot=300, nlev=5)
    x = st.device_kernel_inputs(300, dtype=torch.float64, device="cpu", pqs=True)
    pre = ck.plain_prelude(x, st.params)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(17):
            tk.launch_cloudsc2_ad(x, pre, None, (), st.params)
    assert [i for i, (e, _) in enumerate(calls) if e == "cloudsc2_ad_stamped"] == [0, 8, 16]
    assert all(e == "cloudsc2_ad" for i, (e, _) in enumerate(calls) if i % 8)
    assert cpu_recorder._rings[torch.device("cpu")][1] == 3 * 12
    assert [r.stamped for r in cpu_recorder.records()] == [i % 8 == 0 for i in range(17)]


def test_the_summary_times_the_shipped_launches(monkeypatch):
    """Four calls, the first and third stamped (``STAMP_EVERY`` 2): the
    sweep's device and self times are the two shipped launches' mean times
    four, its counters of the instance the shipped launches', the twin's
    and the stamps' the stamped launches'; the entry span's self time is
    its own less each call's sweep as it ran."""
    _stamp_on_the_cpu(monkeypatch, 64, every=2)
    rec = spans.Recorder()
    like = torch.zeros(1)
    timeline = [(BASE, BASE + 100, 0), (BASE, BASE + 50, 1), (BASE + 60, BASE + 90, 1)]
    for i in range(4):
        with rec.span("run", like):
            with rec.span("sweep", like):
                slice_ = rec.stamps(like, 3, 1)
                twin = {} if slice_ is None else {"twin_blocks_per_sm": 1}
                rec.count(lambda: {"registers": 40 + i, **twin})
                if slice_ is not None:
                    slice_.copy_(_records(timeline))
    recs = rec.records()
    sweeps = [r for r in recs if r.name == spans.PREFIX + "sweep"]
    assert [r.stamped for r in sweeps] == [True, False, True, False]
    assert not any(r.stamped for r in recs if r not in sweeps)
    for r in recs:  # stamped sweeps 3 ms, shipped ones 1 and 2 ms, calls 10 ms
        r.device_ms = (10.0 if r not in sweeps else 3.0 if r.stamped
                       else 1.0 + r.call // 2)
    got = rec.summary()
    sweep, run = got[spans.PREFIX + "sweep"], got[spans.PREFIX + "run"]
    assert sweep["count"] == 4 and run["count"] == 4
    assert sweep["device_ms"] == pytest.approx(4 * 1.5) == sweep["self_ms"]
    assert run["device_ms"] == 40.0 and run["self_ms"] == pytest.approx(40 - 3 - 1 - 3 - 2)
    assert sweep["counters"] == pytest.approx({
        "registers": 42.0, "twin_blocks_per_sm": 1.0, "kernel_ms": 100e-6,
        "tail_ms": 10e-6, "sms": 2, "fill_pct": 100.0 * 180 / 200}, rel=1e-12)
    assert run["counters"] == {}


def test_the_level_headers_are_read_once_per_body(monkeypatch):
    """Repeated traced launches of the TL (both contracts' builds) and the
    AD read each generated header at most once per body ``(kind, evap,
    lregcl)`` in the process."""
    calls = _stub_launches(monkeypatch)
    monkeypatch.setattr(tk, "_tl_launch", lambda *a, **k: (None, None, ()))
    reads = []
    real = pathlib.Path.read_text

    def counted(path, *a, **k):
        if path.name.endswith("_level.cuh"):
            reads.append(path.name)
        return real(path, *a, **k)

    monkeypatch.setattr(pathlib.Path, "read_text", counted)
    tk.level_counts.cache_clear()
    st = Cloudsc2State.synthetic(ngptot=12, nlev=5)
    x = st.device_kernel_inputs(6, dtype=torch.float64, device="cpu", pqs=True)
    pre = ck.plain_prelude(x, st.params)
    bodies = [(evap, lregcl) for evap in (False, True) for lregcl in (False, True)]
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            for evap, lregcl in bodies:
                kw = dict(ldrain1d=evap, lregcl=lregcl)
                tk.launch_cloudsc2_tl(x, pre, st.params, dscale=0.01, **kw)
                tk.launch_cloudsc2_tl_std(x, pre, st.params, dscale=0.01, **kw)
                tk.launch_cloudsc2_ad(x, pre, None, (), st.params, **kw)
    assert len(calls) == 3 * len(bodies)  # the AD's launches
    assert sorted(reads) == sorted(["cloudsc2_tl_level.cuh"] * 4
                                   + ["cloudsc2_ad_level.cuh"] * 4)
    spans.clear()


# ------------------------------------------------------------------ the card
NCOL = 16_384


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _bits(t):
    return None if t is None else t.view(torch.int32 if t.element_size() == 4 else torch.int64)


def _same(a, b):
    flat_a = [t for t in _flatten(a)]
    flat_b = [t for t in _flatten(b)]
    assert len(flat_a) == len(flat_b)
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(flat_a, flat_b))


def _flatten(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _flatten(v)


def _sweep(kind, dtype, evap, variant, ncol=NCOL):
    """A launch of the sweep ``kind`` on a synthetic store at ``ncol``
    columns: a function of no arguments returning its outputs."""
    st = Cloudsc2State.synthetic(ngptot=100, nlev=137)
    x = st.device_kernel_inputs(ncol, dtype=dtype, device="cuda", pqs=kind != "nl")
    pre = ck.kernel_prelude(x, st.params)
    if kind == "nl":
        return lambda: ck.launch_cloudsc2_nl(x, pre, st.params, ldrain1d=evap)
    if kind == "tl":
        if variant == "std":
            return lambda: tk.launch_cloudsc2_tl_std(x, pre, st.params, dscale=0.01,
                                                     ldrain1d=evap)
        return lambda: tk.launch_cloudsc2_tl(x, pre, st.params, dscale=0.01, ldrain1d=evap,
                                             write_primal=variant == "primal")
    _, dout, ckpts = tk.launch_cloudsc2_tl(x, pre, st.params, dscale=0.01, ldrain1d=evap,
                                           write_primal=False)
    return lambda: tk.launch_cloudsc2_ad(x, pre, dout, ckpts, st.params, ldrain1d=evap)


CASES = ([("nl", d, e, None) for d in ("f32", "f64") for e in (False, True)]
         + [("tl", d, False, v) for d in ("f32", "f64") for v in ("noprim", "primal", "std")]
         + [("tl", "f32", True, v) for v in ("noprim", "std")]
         + [("ad", d, e, None) for d in ("f32", "f64") for e in (False, True)])
SPAN = {"nl": "nl_sweep", "tl": "tl_sweep", "ad": "ad_sweep"}
# the cases of CASES whose instance a benchmark cell launches
CELL_SWEEPS = {"nl": {("f32", False, None), ("f64", False, None)},
               "tl": {("f32", False, "noprim"), ("f32", False, "primal"), ("f32", False, "std"),
                      ("f32", True, "noprim"), ("f64", False, "noprim")},
               "ad": {("f32", False, None), ("f32", True, None), ("f64", False, None)}}
DTYPES = {"f32": torch.float32, "f64": torch.float64}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype,evap,variant", CASES)
def test_the_stamped_twin_writes_the_shipped_outputs(kind, dtype, evap, variant,
                                                    monkeypatch):
    """The twin (launched while the profiler records, every call stamping)
    against its shipped instance on the same inputs: the outputs bit for
    bit; one record a warp of the grid and nothing past them; every warp's
    time within its span's; ``kernel_ms`` within the span's device time;
    ``sms`` at most the grid's blocks and the card's SMs; the twin's
    blocks an SM, which the fill divides by, the shipped instance's where a
    cell launches it."""
    _need_cuda()
    monkeypatch.setattr(spans, "STAMP_EVERY", 1)
    launch = _sweep(kind, DTYPES[dtype], evap, variant)
    shipped = launch()
    torch.cuda.synchronize()
    ring, head = spans._recorder._ring_of(torch.device("cuda", 0))
    ring.fill_(-1)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        stamped = launch()
        torch.cuda.synchronize()
    ring, new_head = spans._recorder._rings[torch.device("cuda", 0)]
    assert _same(shipped, stamped)
    blocks = -(-NCOL // 128)
    first = head % spans.STAMP_RING
    assert new_head - head == 4 * blocks and first + 4 * blocks <= spans.STAMP_RING
    got = ring[first:first + 4 * blocks + 8].cpu()
    assert (got[4 * blocks:] == -1).all() and (got[:4 * blocks, 0] != -1).all()
    (rec,) = [r for r in spans.records() if r.name == spans.PREFIX + SPAN[kind]]
    durations = got[:4 * blocks, 1] & 0xFFFFFFFF
    assert int(durations.max()) <= rec.device_ms * 1e6
    c = rec.counters
    assert 0 < c["kernel_ms"] <= rec.device_ms
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert 1 <= c["sms"] <= min(blocks, sms)
    assert 0 < c["fill_pct"] <= 100 and 0 <= c["tail_ms"] <= c["kernel_ms"]
    if (dtype, evap, variant) in CELL_SWEEPS[kind]:
        assert c["twin_blocks_per_sm"] == c["blocks_per_sm"], c


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["nl", "tl", "ad"])
def test_a_grid_of_more_blocks_than_sms_is_seen_on_every_sm(kind, monkeypatch):
    """At 65,536 columns (512 blocks) the stamps see every SM of the card."""
    _need_cuda()
    monkeypatch.setattr(spans, "STAMP_EVERY", 1)
    launch = _sweep(kind, torch.float32, False, "noprim", ncol=65_536)
    launch()
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        launch()
        torch.cuda.synchronize()
    (rec,) = [r for r in spans.records() if r.name == spans.PREFIX + SPAN[kind]]
    assert rec.counters["sms"] == torch.cuda.get_device_properties(0).multi_processor_count


# The parent's library digests (chip_smoke.EXACT_SASS before the twins were
# added), under nvcc release 12.9, V12.9.86: the digest of the entries that
# are not twins must be these
PARENT_SASS = {
    ("cloudsc2_nl", ()): "b2c4a9637915d6568094fc4306ec116494c72ef31eafd672e5f1f43025f7af60",
    ("cloudsc2_tl", ()): "dd020d5c979766baa468e20300abf4109d7572c92c7b41a7b2c9e33350367375",
    ("cloudsc2_tl", build.NO_FMA):
        "637e39665d2630c721765b4c0cd544fcc0dfb8a0e774ea677fc2d081ef1a6748",
    ("cloudsc2_ad", ()): "7b2e800b012438d35f6401ec4c5c87eb365bd6ae476d8a50c15facc9a3bdb54a",
}
PARENT_RELEASE = "release 12.9, V12.9.86"


@pytest.mark.cuda
def test_the_shipped_entries_keep_their_sass():
    """Each library's entries but the twins have the parent's SASS, entry
    for entry; the twin of each instance a cell runs has registers for as
    many blocks an SM as its shipped instance."""
    _need_cuda()
    m = re.search(r"release ([\d.]+), V([\d.]+)", build.nvcc_version())
    if m is None or m.group(0) != PARENT_RELEASE:
        pytest.skip(f"digests recorded under nvcc {PARENT_RELEASE}")
    build.load_libraries([(name, (), flags) for name, flags in PARENT_SASS])
    for (name, flags), want in PARENT_SASS.items():
        digests = build.sass_digests(build.sass(name, (), flags))
        shipped = {e: d for e, d in digests.items() if "_stamped_" not in e}
        assert len(digests) > len(shipped)
        assert build.library_digest(shipped) == want, (name, flags)
        regs = {r["entry"]: r["registers"] for r in build.ptxas_report(name, (), flags)}
        twins = {_instance(e): _blocks(n) for e, n in regs.items() if "_stamped_" in e}
        shipped = {_instance(e): _blocks(n) for e, n in regs.items() if "_stamped_" not in e}
        cells = {k: v for k, v in twins.items() if k[1:] in CELL_INSTANCES[name]}
        assert cells and all(shipped[k] == n for k, n in cells.items()), (regs, name)


# the type and switches (evap, lregcl[, write_primal]) of the instances the
# cells run
CELL_INSTANCES = {
    "cloudsc2_nl": (("f", "Lb0E"), ("d", "Lb0E")),
    "cloudsc2_tl": (("f", "Lb0ELb1ELb0E"), ("f", "Lb0ELb1ELb1E"), ("f", "Lb1ELb1ELb0E"),
                    ("d", "Lb0ELb1ELb0E")),
    "cloudsc2_ad": (("f", "Lb0ELb1E"), ("f", "Lb1ELb1E"), ("d", "Lb0ELb1E")),
}


def _blocks(registers):
    """Blocks of 128 threads the registers of an SM of compute capability
    9.0 allow (allocated per warp in units of 256), at most 16."""
    return min(65536 // (-(-registers * 32 // 256) * 256) // 4, 16)


_KERNEL = re.compile(r"(cloudsc2_[a-z_]+?)_kernelI([fd])((?:Lb[01]E)*)")


def _instance(mangled):
    """A kernel's name without ``_stamped``, its type and its flags, from
    its mangled name."""
    m = _KERNEL.search(mangled)
    return m.group(1).replace("_stamped", ""), m.group(2), m.group(3)


# one process per mode: a traced run_nl and run_tlad, three calls each, under
# the profiler with the card's activity, every call stamping or none, and
# the runtime calls that allocate, copy or synchronise inside each
# cloudsc2.run_* range after the first
_RUNTIME_CALLS = """
import json, sys, tempfile, torch
from torch.profiler import ProfilerActivity, profile
from cloudsc2jax_torch import drivers, spans
from cloudsc2jax_torch.state import Cloudsc2State
if sys.argv[1] == "patched":
    spans.stamped = lambda entry, like, ncol: (entry, ())
spans.STAMP_EVERY = 1
st = Cloudsc2State.synthetic(ngptot=100, nlev=137)
xs = {"run_nl": st.device_kernel_inputs(16_384, dtype=torch.float32, device="cuda"),
      "run_tlad": st.device_kernel_inputs(16_384, dtype=torch.float32, device="cuda",
                                          pqs=True)}
for entry, x in xs.items():
    getattr(drivers, entry)(x, st.params)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for entry, x in xs.items():
        for _ in range(3):
            getattr(drivers, entry)(x, st.params)
    torch.cuda.synchronize()
path = tempfile.mktemp(suffix=".json")
prof.export_chrome_trace(path)
events = [e for e in json.load(open(path))["traceEvents"] if e.get("ph") == "X"]
ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                if e["name"] in ("cloudsc2.run_nl", "cloudsc2.run_tlad")
                and e.get("cat") == "user_annotation")
picked = ("Malloc", "Memcpy", "Synchronize")
calls = [(e["ts"], e["name"]) for e in events if e.get("cat") == "cuda_runtime"
         and any(p in e["name"] for p in picked)]
out = []
for i, (lo, hi, name) in enumerate(ranges):
    out.append([name, sorted(n for ts, n in calls if lo <= ts < hi)])
print(json.dumps({"ranges": out, "launches": sum("stamped" in e["name"] for e in events)}))
"""


@pytest.mark.cuda
def test_the_stamps_add_no_allocation_copy_or_synchronise():
    """The runtime calls that allocate, copy or synchronise inside each
    traced ``run_nl`` and ``run_tlad`` call after the first are the same
    with the stamps as with the stamped entries patched out."""
    _need_cuda()
    got = {}
    for mode in ("stamped", "patched"):
        res = subprocess.run([sys.executable, "-c", _RUNTIME_CALLS, mode],
                             capture_output=True, text=True, timeout=600, cwd=ROOT)
        assert res.returncode == 0, res.stderr[-4000:]
        got[mode] = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["stamped"]["launches"] > 0 and got["patched"]["launches"] == 0
    stamped, patched = got["stamped"]["ranges"], got["patched"]["ranges"]
    assert [n for n, _ in stamped] == [n for n, _ in patched] == (
        ["cloudsc2.run_nl"] * 3 + ["cloudsc2.run_tlad"] * 3)
    assert [c for _, c in stamped[1:3] + stamped[4:]] == [
        c for _, c in patched[1:3] + patched[4:]]
