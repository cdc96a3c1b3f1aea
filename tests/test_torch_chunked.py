"""Chunked streaming (``drivers.run_chunked``) against the JAX package.

Both packages load one input store, written from the JAX package's
synthetic state, so their stored columns are the same bits.  The JAX side
runs its Pallas kernels in interpret mode with one sublane (128-column
blocks), the port its plain versions on the CPU in f32; both chunk the same
global columns.  Tolerances are the JAX package's own for its
decomposition tests (``tests/test_dist.py``): 1e-5 for ``nl``, 1e-4 for
``tlad``, relative to the checksum.
"""

import numpy as np
import pytest
import torch

from cloudsc2jax import io as jio
from cloudsc2jax.drivers import run_chunked as jrun_chunked
from cloudsc2jax.state import Cloudsc2State as JState
from cloudsc2jax_torch import drivers
from cloudsc2jax_torch import state as tstate_mod
from cloudsc2jax_torch.drivers import chunk_columns, chunk_loop, run_chunked
from cloudsc2jax_torch.state import Cloudsc2State, tile_stored_columns

NGPTOT = 512
RTOL = {"nl": 1e-5, "tlad": 1e-4}
NLEV = {"nl": 13, "tlad": 9}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """variant -> (JAX state, port state) of one input store each."""
    out = {}
    for variant, nlev in NLEV.items():
        raw, params = jio.synthetic_state(nlon=100, nlev=nlev)
        path = tmp_path_factory.mktemp("chunked") / f"input{nlev}.npz"
        jio.write_input_h5(path, raw, params)
        out[variant] = (JState.load(path), Cloudsc2State.load(path))
    return out


def _port(stores, variant, **kw):
    return run_chunked(stores[variant][1], NGPTOT, variant=variant, sublanes=1,
                       device="cpu", **kw)


def _jax(stores, variant, **kw):
    return jrun_chunked(stores[variant][0], NGPTOT, variant=variant, sublanes=1,
                        interpret=True, **kw)


@pytest.mark.parametrize("variant", ["nl", "tlad"])
@pytest.mark.parametrize("chunk", [256, 512])
def test_checksum_matches_jax(stores, variant, chunk):
    """The same columns processed and the same checksum (rtol 1e-5 nl,
    1e-4 tlad) for chunks of 256 and 512 columns."""
    n, s = _port(stores, variant, chunk=chunk)
    jn, js = _jax(stores, variant, chunk=chunk)
    assert n == jn == NGPTOT
    np.testing.assert_allclose(s, js, rtol=RTOL[variant])


@pytest.mark.parametrize("variant,kw", [
    ("nl", dict(probe="slice")),
    ("tlad", dict(probe="slice")),
    ("tlad", dict(write_primal=False)),
    ("nl", dict(fused_gen=True)),
])
def test_probes_and_options_match_jax(stores, variant, kw):
    """The slice probe, the TL+AD unit without primal streams and
    ``fused_gen``'s rounding up to lcm(128, 100) = 3,200 columns give the
    JAX package's columns and value (same tolerances)."""
    n, s = _port(stores, variant, chunk=256, **kw)
    jn, js = _jax(stores, variant, chunk=256, **kw)
    assert n == jn == (3200 if kw.get("fused_gen") else NGPTOT)
    np.testing.assert_allclose(s, js, rtol=RTOL[variant])


@pytest.mark.parametrize("variant", ["nl", "tlad"])
def test_chunk_size_changes_nothing(stores, variant):
    """One, two and four chunks over the same 512 columns: the checksum up
    to f32 reassociation (rtol 1e-5 nl, 1e-4 tlad)."""
    sums = [_port(stores, variant, chunk=c) for c in (512, 256, 128)]
    assert [n for n, _ in sums] == [NGPTOT] * 3
    for _, s in sums[1:]:
        np.testing.assert_allclose(s, sums[0][1], rtol=RTOL[variant])


@pytest.mark.parametrize("variant,probe", [("nl", "checksum"), ("nl", "slice"),
                                           ("tlad", "checksum")])
def test_fused_gen_is_bit_identical_to_regeneration(stores, variant, probe):
    """One generation for the whole run against a generation per chunk at
    its offset: value-identical inputs, so the same bits, over two chunks
    of the rounded size."""
    st = stores[variant][1]
    chunk = chunk_columns(st, 256, variant=variant, sublanes=1, fused_gen=True)
    assert chunk == 3200
    kw = dict(variant=variant, sublanes=1, device="cpu", probe=probe)
    fused = run_chunked(st, 2 * chunk, chunk=256, fused_gen=True, **kw)
    regen = run_chunked(st, 2 * chunk, chunk=chunk, **kw)
    assert fused == regen
    assert fused[0] == 2 * chunk


def test_chunk_rounding():
    """Whole sublanes·128-column groups (128 for nl and 64 for tlad by
    default), never fewer than one; up to the expansion's period with
    ``fused_gen``; as ``cloudsc2jax/drivers.py:573-584`` rounds."""
    st = Cloudsc2State.synthetic(ngptot=100, nlev=5)
    assert chunk_columns(st, 524288) == 524288
    assert chunk_columns(st, 20000) == 16384
    assert chunk_columns(st, 20000, variant="tlad") == 16384
    assert chunk_columns(st, 10000, variant="tlad") == 8192
    assert chunk_columns(st, 100) == 16384
    assert chunk_columns(st, 327680, fused_gen=True) == 409600
    assert chunk_columns(st, 300, sublanes=1) == 256
    with pytest.raises(ValueError):
        chunk_columns(st, 256, variant="tl")


def test_mesh_and_bad_arguments_raise(stores):
    """A mesh that is no ``dist.ColumnMesh``, or whose lanes are not of
    ``device``'s type, is refused, as are an unknown probe and
    ``write_primal=False`` for ``nl``."""
    from cloudsc2jax_torch.dist import ColumnMesh

    st = stores["nl"][1]
    with pytest.raises(TypeError, match="ColumnMesh"):
        run_chunked(st, NGPTOT, chunk=256, sublanes=1, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="lanes are cpu"):
        run_chunked(st, NGPTOT, chunk=256, sublanes=1, device="cuda",
                    mesh=ColumnMesh(["cpu"]))
    with pytest.raises(ValueError):
        run_chunked(st, NGPTOT, chunk=256, sublanes=1, device="cpu", probe="all")
    with pytest.raises(ValueError):
        run_chunked(st, NGPTOT, chunk=256, sublanes=1, device="cpu",
                    write_primal=False)


def test_one_read_per_run(stores):
    """The chunks chain through one 0-d f32 accumulator on the device;
    ``run_chunked`` is ``chunk_loop`` and one read of it."""
    st = stores["nl"][1]
    n, acc = chunk_loop(st, NGPTOT, chunk=128, sublanes=1, device="cpu")
    assert n == NGPTOT and acc.dim() == 0 and acc.dtype == torch.float32
    assert float(acc) == run_chunked(st, NGPTOT, chunk=128, sublanes=1,
                                     device="cpu")[1]


@pytest.mark.parametrize("col_offset", [0, 37, 100])
def test_tiling_of_resident_columns(stores, col_offset):
    """The device-resident generation equals the JAX package's cyclic
    expansion at the same offset bit for bit (pqs: each package's own SATUR
    of the same fields, within 4 ulp), and the port's tiling of a fresh
    upload of its stored columns bit for bit."""
    jst, st = stores["nl"]
    ncol = 230
    mine = tile_stored_columns(st.stored_inputs(torch.float64, "cpu", pqs=True),
                               ncol, col_offset)
    theirs = jst.device_kernel_inputs(ncol, dtype=np.float64, levels_major=True,
                                      col_offset=col_offset)
    fresh = st.kernel_inputs(torch.float64, "cpu")
    idx = (col_offset + np.arange(ncol)) % st.klon_file
    for name, a, b, c in zip(mine._fields, mine, theirs, fresh):
        assert a.numpy().tobytes() == c.numpy()[:, idx].tobytes(), name
        b = np.asarray(b)
        if name == "pqs":
            np.testing.assert_allclose(a.numpy(), b,
                                       rtol=4 * np.finfo(np.float64).eps, atol=0)
        else:
            assert a.numpy().tobytes() == b.tobytes(), name


def test_each_chunk_is_generated_at_its_offset(stores, monkeypatch):
    """The inputs of chunk i are ``device_kernel_inputs(chunk,
    col_offset=i·chunk)``, bit for bit."""
    st = stores["tlad"][1]
    seen = []
    run_tlad = drivers.run_tlad

    def spy(inputs, params, **kw):
        seen.append(inputs)
        return run_tlad(inputs, params, **kw)

    monkeypatch.setattr(drivers, "run_tlad", spy)
    run_chunked(st, 3 * 128 - 5, variant="tlad", chunk=128, sublanes=1,
                device="cpu")
    assert len(seen) == 3
    for i, got in enumerate(seen):
        ref = st.device_kernel_inputs(128, dtype=torch.float32, device="cpu",
                                      pqs=True, col_offset=i * 128)
        for name, a, b in zip(got._fields, got, ref):
            assert torch.equal(a, b), (i, name)


def test_stored_columns_cross_once(monkeypatch):
    """``device_kernel_inputs`` uploads the stored columns once per dtype
    and device and runs SATUR on them once, whatever the number of calls
    (before, every call uploaded them and, with pqs, ran SATUR again)."""
    st = Cloudsc2State.synthetic(ngptot=100, nlev=7)
    uploads, saturs = [], []
    stored = Cloudsc2State._stored_inputs
    satur = tstate_mod.satur

    def count_upload(self, *a, **k):
        uploads.append(1)
        return stored(self, *a, **k)

    def count_satur(*a, **k):
        saturs.append(1)
        return satur(*a, **k)

    monkeypatch.setattr(Cloudsc2State, "_stored_inputs", count_upload)
    monkeypatch.setattr(tstate_mod, "satur", count_satur)
    first = st.device_kernel_inputs(300, dtype=torch.float32, device="cpu", pqs=True)
    for offset in (128, 256):
        st.device_kernel_inputs(300, dtype=torch.float32, device="cpu",
                                pqs=True, col_offset=offset)
        st.device_kernel_inputs(300, dtype=torch.float32, device="cpu",
                                col_offset=offset)
    again = st.device_kernel_inputs(300, dtype=torch.float32, device="cpu", pqs=True)
    assert (len(uploads), len(saturs)) == (1, 1)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    st.device_kernel_inputs(300, dtype=torch.float64, device="cpu", pqs=True)
    assert (len(uploads), len(saturs)) == (2, 2)
