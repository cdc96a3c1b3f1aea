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
                        lambda name, defines=(): loaded.append((name, defines)) or lib)
    return build.bind("fake", layouts, launchers, **kw), loaded


def test_bind_checks_the_layout_once_and_declares_the_entries(monkeypatch):
    lib = Library(fake_abi=_abi(3, 5, 7), fake_f32=Entry(), fake_f64=Entry(),
                  fake_names=Entry())
    argtypes = [ctypes.c_void_p, ctypes.c_int]
    got, loaded = _bound(monkeypatch, lib, {"fake_abi": (3, 5, None)},
                         {"fake_f32": argtypes, "fake_f64": argtypes},
                         strings=("fake_names",))
    assert got is lib and loaded == [("fake", ())]
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
