"""The one way Python reaches a library of ``csrc/``: ``build.bind`` checks a
library's argument layout and declares its entries once, ``build.launch``
calls an entry with tensors as pointers on the current stream.  Here, on the
CPU, both run on a stand-in for a loaded library: plain callables that record
what they are given, with the stream and the device context of
``torch.cuda`` replaced by stand-ins too."""

import contextlib
import ctypes

import pytest
import torch

from cloudsc2jax_torch.kernels import build
from cloudsc2jax_torch.kernels import tlad_kernel as tk
from cloudsc2jax_torch.state import Cloudsc2State

STREAM = 4242


class Entry:
    """A library entry: records its calls and returns ``err``."""

    def __init__(self, err=0, body=None):
        self.err, self.body, self.calls = err, body, []

    def __call__(self, *args):
        self.calls.append(args)
        if self.body:
            self.body(*args)
        return self.err


class Library:
    """A stand-in for a loaded ``ctypes.CDLL``: its entries as attributes."""

    def __init__(self, **entries):
        self.__dict__.update(entries)


def _abi(*counts):
    def write(out):
        for i, c in enumerate(counts):
            out[i] = c
    return Entry(body=write)


@pytest.fixture
def fake_cuda(monkeypatch):
    """``torch.cuda.device`` and ``current_stream`` as stand-ins: the
    devices entered, and a stream whose handle is ``STREAM``."""
    entered = []

    @contextlib.contextmanager
    def device(d):
        entered.append(d)
        yield

    class Stream:
        cuda_stream = STREAM

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    return entered


def _bound(monkeypatch, lib, layouts, launchers, **kw):
    loaded = []
    monkeypatch.setattr(build, "load_library",
                        lambda name, defines=(), flags=():
                        loaded.append((name, defines, flags)) or lib)
    return build.bind("fake", layouts, launchers, **kw), loaded


def test_bind_checks_the_layout_once_and_declares_the_entries(monkeypatch):
    lib = Library(fake_abi=_abi(3, 5, 7), fake_f32=Entry(), fake_f64=Entry(),
                  fake_names=Entry())
    argtypes = [ctypes.c_void_p, ctypes.c_int]
    got, loaded = _bound(monkeypatch, lib, {"fake_abi": (3, 5, None)},
                         {"fake_f32": argtypes, "fake_f64": argtypes},
                         strings=("fake_names",))
    assert got is lib and loaded == [("fake", (), ())]
    assert lib.layouts == {"fake_abi": (3, 5, 7)}
    for entry in (lib.fake_f32, lib.fake_f64, lib.fake_abi):
        assert entry.restype is ctypes.c_int
    assert lib.fake_f32.argtypes == argtypes
    assert lib.fake_abi.argtypes == [ctypes.POINTER(ctypes.c_int)]
    assert lib.fake_names.argtypes == [] and lib.fake_names.restype is ctypes.c_char_p
    assert not lib.fake_names.calls
    # bound once per library: a second bind reads and declares nothing
    lib.fake_f32.argtypes = None
    assert build.bind("fake", {"fake_abi": (0,)}, {"fake_f32": []}) is lib
    assert len(lib.fake_abi.calls) == 1 and lib.fake_f32.argtypes is None


def test_bind_refuses_a_layout_mismatch(monkeypatch):
    lib = Library(fake_abi=_abi(3, 5, 7), fake_f32=Entry())
    with pytest.raises(RuntimeError, match=r"fake\.cu: fake_abi gives the layout "
                                           r"\(3, 5, 7\), the wrapper expects "
                                           r"\(3, 6, None\)"):
        _bound(monkeypatch, lib, {"fake_abi": (3, 6, None)}, {"fake_f32": []})
    assert not getattr(lib, "_bound", False)


@pytest.mark.parametrize("dtype,suffix", [(torch.float32, "_f32"),
                                          (torch.float64, "_f64")])
def test_launch_picks_the_entry_by_dtype(fake_cuda, dtype, suffix):
    lib = Library(fake_f32=Entry(), fake_f64=Entry())
    like = torch.zeros(2, dtype=dtype)
    build.launch(lib, "fake", like, 1)
    called = getattr(lib, "fake" + suffix)
    other = lib.fake_f64 if suffix == "_f32" else lib.fake_f32
    assert called.calls == [(1, STREAM)] and not other.calls
    assert fake_cuda == [like.device]


def test_launch_refuses_a_dtype_without_an_entry(fake_cuda):
    lib = Library(fake_f32=Entry(), fake_f64=Entry())
    with pytest.raises(TypeError, match="fake takes float32 or float64"):
        build.launch(lib, "fake", torch.zeros(2, dtype=torch.int16))
    assert not lib.fake_f32.calls and not lib.fake_f64.calls


def test_launch_passes_pointers_arrays_and_null_pointers(fake_cuda):
    lib = Library(fake_f32=Entry())
    a, b, c = (torch.zeros(3) for _ in range(3))
    consts = (ctypes.c_double * 2)(1.5, 2.5)
    build.launch(lib, "fake", a, [a, None, b], (c,), c, consts, 2.0, 7)
    (args,) = lib.fake_f32.calls
    arrays, single, rest = args[:2], args[2], args[3:]
    assert list(arrays[0]) == [a.data_ptr(), None, b.data_ptr()]
    assert list(arrays[1]) == [c.data_ptr()]
    assert all(isinstance(x, ctypes.Array) for x in arrays)
    assert single == c.data_ptr()
    # anything else goes as it is, and the current stream last
    assert rest == (consts, 2.0, 7, STREAM)


def test_launch_raises_on_a_refused_launch(fake_cuda):
    lib = Library(fake_f64=Entry(err=700))
    with pytest.raises(RuntimeError, match="^fake kernel launch failed: cudaError_t 700$"):
        build.launch(lib, "fake", torch.zeros(1, dtype=torch.float64))


def test_a_query_takes_no_stream_and_a_device_names_the_entry(fake_cuda):
    out = (ctypes.c_int * 1)()
    lib = Library(fake_plan=Entry(), fake_plan_f32=Entry(err=2))
    device = torch.device("cpu")
    build.launch(lib, "fake_plan", device, 3, out, stream=False)
    assert lib.fake_plan.calls == [(3, out)] and fake_cuda == [device]
    with pytest.raises(RuntimeError, match="^fake_plan query failed: cudaError_t 2$"):
        build.launch(lib, "fake_plan", torch.zeros(1), out, stream=False)


def test_param_array_holds_the_names_to_the_layout():
    """The TL/AD family's params: the names the library gives, held to the
    count its abi wrote, read once and cached on the library."""
    params = Cloudsc2State.synthetic(ngptot=4, nlev=3).params
    lib = Library(layouts={"fake_abi": (2, 3)},
                  fake_param_names=lambda: b"yomcst.rg ptsphy yrecldp.rlmin")
    arr = tk._param_array(lib, "fake", params)
    assert list(arr) == [params.yomcst.rg, params.ptsphy, params.yrecldp.rlmin]
    assert lib.param_names == ["yomcst.rg", "ptsphy", "yrecldp.rlmin"]
    lib.fake_param_names = None  # cached: not read again
    assert list(tk._param_array(lib, "fake", params)) == list(arr)
    short = Library(layouts={"fake_abi": (2, 4)}, fake_param_names=lambda: b"ptsphy")
    with pytest.raises(RuntimeError, match="argument layout"):
        tk._param_array(short, "fake", params)


def test_the_standard_tl_launch_writes_into_the_rows_given(fake_cuda, monkeypatch):
    """``launch_cloudsc2_tl_std`` launches the build of ``cloudsc2_tl``
    without FMA contraction (``build.NO_FMA``), bound beside the stream
    contract's default build, in its layout: the 20 streams, then 8
    tangents, 3 checkpoints and 8 primal outputs, the flux streams the rows
    1.. of the fields given; then the params, dscale, the shape, the
    switches and write_primal 1."""
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as kmod

    st = Cloudsc2State.synthetic(ngptot=6, nlev=5)
    x = st.device_kernel_inputs(6, dtype=torch.float32, device="cpu", pqs=True)
    pre = kmod.plain_prelude(x, st.params)
    entry, bound = Entry(), []

    def library(name, flags=()):
        bound.append((name, flags))
        return Library(cloudsc2_tl_f32=entry)

    monkeypatch.setattr(tk, "_library", library)
    monkeypatch.setattr(tk, "_param_array", lambda lib, name, params: "params")
    monkeypatch.setattr(tk, "_check_launch", lambda *args: None)
    flux, d_flux = kmod.flux_rows(x.pt), kmod.flux_rows(x.pt)
    launches = tk.cloudsc2_tl_std.launches
    out, dout, ckpts = tk.launch_cloudsc2_tl_std(
        x, pre, st.params, dscale=0.01,
        out={**kmod.flux_slots(flux), **kmod.flux_slots(d_flux, "d_")})
    assert tk.cloudsc2_tl_std.launches == launches + 1
    assert bound == [("cloudsc2_tl", build.NO_FMA)]
    (args,) = entry.calls
    operands = {**x._asdict(), **pre._asdict()}
    assert list(args[0]) == [operands[n].data_ptr() for n in tk.TL_STREAMS]
    outs = list(args[1])
    assert outs == [t.data_ptr() for t in (*dout, *ckpts, *out)]
    assert outs[6:8] == [d_flux.pfplsl[1].data_ptr(), d_flux.pfplsn[1].data_ptr()]
    assert outs[17:] == [flux.pfplsl[1].data_ptr(), flux.pfplsn[1].data_ptr()]
    assert len(set(outs)) == 19
    assert args[2:] == ("params", 0.01, 6, 5, 0, 1, 1, STREAM)
    assert build.NO_FMA == ("-fmad=false",)
    assert build._key(("cloudsc2_tl", (), build.NO_FMA))[2] == build.NO_FMA
    assert "-fmad=false" not in build._key("cloudsc2_tl")[2]


def test_the_smoke_builds_and_pins_the_standard_tl(monkeypatch):
    """``chip_smoke.py`` phase 2 builds ``cloudsc2_tl`` a second time with
    ``build.NO_FMA`` (the standard contract's TL) and holds that build's
    SASS to a recorded digest of its own, beside the default build's, the
    one recorded when the TL level body came to divide once per divisor."""
    monkeypatch.syspath_prepend(str(build.CSRC.parents[1]))
    import chip_smoke

    assert chip_smoke.STD_TL == ("cloudsc2_tl", (), build.NO_FMA)
    assert "cloudsc2_tl" in chip_smoke.LIBRARIES
    assert chip_smoke.KERNEL_MIX["cloudsc2_tl_std"] == chip_smoke.KERNEL_MIX["cloudsc2_tl"]
    pinned = {k: v for k, v in chip_smoke.EXACT_SASS.items() if k.startswith("cloudsc2_tl")}
    assert pinned["cloudsc2_tl"].startswith("dd020d5c")
    assert len(set(pinned.values())) == len(pinned)
    assert set(pinned) >= {"cloudsc2_tl", "cloudsc2_tl -fmad=false", "cloudsc2_tl_din"}


def _counters(*values):
    """An occupancy entry that writes ``values`` into its counters."""
    def write(*args):
        out = args[-1]
        for i, v in enumerate(values):
            out[i] = v
    return Entry(body=write)


def test_occupancy_reads_each_instance_once(fake_cuda):
    """``build.occupancy`` asks the library's ``<entry>_occupancy`` of the
    tensor's dtype, with the launch's switches and no stream, for the
    counters of ``build.OCCUPANCY``, once per library, instance and card."""
    lib = Library(fake_occupancy_f32=_counters(40, 0, 0, 12),
                  fake_occupancy_f64=_counters(92, 8, 0, 5))
    like = torch.zeros(2, dtype=torch.float64)
    want = {"dtype": 64, "registers": 92, "local_bytes": 8, "shared_bytes": 0,
            "blocks_per_sm": 5}
    assert build.occupancy(lib, "fake", like, 0) == want
    assert build.occupancy(lib, "fake", like, 0) == want
    (args,) = lib.fake_occupancy_f64.calls
    assert args[0] == 0 and len(args[1]) == len(build.OCCUPANCY) == 4
    # another instance (its switches, its dtype) is read once of its own
    build.occupancy(lib, "fake", like, 1)
    assert len(lib.fake_occupancy_f64.calls) == 2
    assert build.occupancy(lib, "fake", like.float(), 0)["registers"] == 40
    assert build.occupancy(lib, "fake", like.float(), 0)["dtype"] == 32
    assert len(lib.fake_occupancy_f32.calls) == 1
    # a refused query raises and is not cached
    bad = Library(fake_occupancy_f64=Entry(err=98))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="^fake_occupancy query failed"):
            build.occupancy(bad, "fake", like, 0)
    assert len(bad.fake_occupancy_f64.calls) == 2
    # bind's declarations: the switches, then the counters
    queries = build.occupancy_queries("fake", 2)
    assert set(queries) == {"fake_occupancy_f32", "fake_occupancy_f64"}
    assert queries["fake_occupancy_f64"] == [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]


def test_the_sweeps_spans_count_through_the_one_reader(monkeypatch):
    """The NL, TL (both builds) and AD launches give their spans the
    counters of ``build.occupancy``, the one reader, asked for the library
    each binds, its entry and the launch's switches, beside ``evap`` (the TL's
    and AD's also beside their level body's divisions and reciprocals, the
    AD's and its shared slots);
    with the profiler off the reader is not asked."""
    from torch.profiler import ProfilerActivity, profile

    from cloudsc2jax_torch import spans
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as kmod

    assert not hasattr(tk, "occupancy") and not hasattr(tk, "OCCUPANCY")
    st = Cloudsc2State.synthetic(ngptot=6, nlev=5)
    x = st.device_kernel_inputs(6, dtype=torch.float64, device="cpu", pqs=True)
    pre = kmod.plain_prelude(x, st.params)
    asked = []

    def reader(lib, entry, like, *switches):
        asked.append((lib, entry, like.dtype, switches))
        return {"dtype": 64, "blocks_per_sm": len(asked)}

    monkeypatch.setattr(build, "occupancy", reader)
    monkeypatch.setattr(build, "launch", lambda *a, **k: None)
    monkeypatch.setattr(kmod, "_load_kernel", lambda: "nl library")
    monkeypatch.setattr(kmod, "_launch", lambda *a, **k: [torch.empty_like(x.pt)] * 8)
    monkeypatch.setattr(tk, "_library", lambda name, flags=(): (name, flags))
    monkeypatch.setattr(tk, "_tl_launch", lambda *a, **k: (None, None, ()))
    monkeypatch.setattr(tk, "_check_launch", lambda *a: None)
    monkeypatch.setattr(tk, "_ad_operands", lambda *a: [])
    monkeypatch.setattr(tk, "_param_array", lambda *a: "params")

    def launches():
        kmod.launch_cloudsc2_nl(x, pre, st.params)
        tk.launch_cloudsc2_tl(x, pre, st.params, dscale=0.01, write_primal=False)
        tk.launch_cloudsc2_tl_std(x, pre, st.params, dscale=0.01)
        tk.launch_cloudsc2_ad(x, pre, None, (), st.params)

    launches()
    assert asked == []
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        launches()
    assert asked == [("nl library", "cloudsc2_nl", torch.float64, (0,)),
                     (("cloudsc2_tl", ()), "cloudsc2_tl", torch.float64, (0, 1, 0)),
                     (("cloudsc2_tl", build.NO_FMA), "cloudsc2_tl", torch.float64, (0, 1, 1)),
                     (("cloudsc2_ad", ()), "cloudsc2_ad", torch.float64, (0, 1))]
    counters = {n: s["counters"] for n, s in spans.summary().items()}
    assert counters == {
        spans.PREFIX + "nl_sweep": {"dtype": 64, "blocks_per_sm": 1, "evap": 0},
        spans.PREFIX + "tl_sweep": {"dtype": 64, "blocks_per_sm": 2.5, "evap": 0,
                                    "divides": 29, "reciprocals": 20, "checkpoints": 1},
        spans.PREFIX + "ad_sweep": {"dtype": 64, "blocks_per_sm": 4, "evap": 0,
                                    "divides": 28, "reciprocals": 19, "stash_slots": 87}}


def test_the_nl_library_binds_its_occupancy_entries(monkeypatch):
    """``csrc/cloudsc2_nl.cu`` exports ``cloudsc2_nl_occupancy_f32/_f64``
    (evap, then the counters), which the NL wrapper declares beside its
    launchers."""
    from cloudsc2jax_torch.kernels import cloudsc2_kernel as kmod

    seen = {}
    monkeypatch.setattr(build, "bind", lambda name, layouts, launchers, **kw:
                        seen.update(name=name, launchers=launchers))
    kmod._load_kernel()
    assert seen["name"] == "cloudsc2_nl"
    assert {k: v for k, v in seen["launchers"].items() if "occupancy" in k} == \
        build.occupancy_queries("cloudsc2_nl", 1)
    source = (build.CSRC / "cloudsc2_nl.cu").read_text()
    for suffix in ("f32", "f64"):
        assert f"int cloudsc2_nl_occupancy_{suffix}(int evap, int* out)" in source
    assert '#include "cloudsc2_occupancy.cuh"' in source


def test_the_smoke_keeps_the_nl_sass_pinned(monkeypatch):
    """The NL library's occupancy entries are host code: ``chip_smoke.py``
    holds its SASS to the digest recorded before them."""
    monkeypatch.syspath_prepend(str(build.CSRC.parents[1]))
    import chip_smoke

    assert chip_smoke.EXACT_SASS["cloudsc2_nl"].startswith("b2c4a963")
    assert "cloudsc2_nl" in chip_smoke.LIBRARIES
