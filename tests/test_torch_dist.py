"""The port's column decomposition (``cloudsc2jax_torch.dist`` and the
drivers' ``mesh=``) on the CPU, against the JAX package on its 8-device CPU
mesh (conftest's ``jax_num_cpu_devices=8``).

The port's mesh here is 8 CPU lanes in one process, the counterpart of the
JAX package's 8 virtual devices.  Where both packages read a synthetic
state, they load one store written from the JAX package's, so their stored
columns are the same bits.  Tolerances are the JAX package's own for its
decomposition tests (``tests/test_dist.py``): 1e-10 for the outputs in f64,
1e-5 (``nl``) and 1e-4 (``tlad``) for the chunk checksums.
"""

import numpy as np
import pytest
import torch

from cloudsc2jax import dist as jdist
from cloudsc2jax import io as jio
from cloudsc2jax.drivers import run_chunked as jrun_chunked
from cloudsc2jax.drivers import run_nl as jrun_nl
from cloudsc2jax.drivers import run_tlad as jrun_tlad
from cloudsc2jax.state import Cloudsc2State as JState
from cloudsc2jax_torch import dist
from cloudsc2jax_torch import validate as tval
from cloudsc2jax_torch.drivers import (
    adjoint_test,
    run_chunked,
    run_nl,
    run_tlad,
    taylor_test,
)
from cloudsc2jax_torch.state import Cloudsc2State

from conftest import FIXTURES

LANES = 8


@pytest.fixture(scope="module")
def jmesh():
    import jax

    assert len(jax.devices()) == LANES, "conftest must provide 8 virtual devices"
    return jdist.column_mesh()


@pytest.fixture(scope="module")
def mesh():
    return dist.ColumnMesh(["cpu"] * LANES)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """nlev -> (JAX state, port state) of one synthetic store each."""
    out = {}
    for nlev in (9, 13):
        raw, params = jio.synthetic_state(nlon=100, nlev=nlev)
        path = tmp_path_factory.mktemp("dist") / f"input{nlev}.npz"
        jio.write_input_h5(path, raw, params)
        out[nlev] = (JState.load(path), Cloudsc2State.load(path))
    return out


def _lanes(state, ngptot, mesh, *, standard=False, pqs=False,
           dtype=torch.float64):
    """Each lane's own columns, expanded from its global offset."""
    make = state.device_inputs if standard else state.device_kernel_inputs
    kw = {} if standard else {"pqs": pqs}
    return [make(s.stop - s.start, dtype=dtype, device=dev, col_offset=s.start, **kw)
            for dev, s in zip(mesh.lanes, dist.lane_slices(ngptot, mesh))]


def _joined(per_lane):
    """The lanes' ``(ncol, ...)`` outputs side by side, field by field."""
    return [torch.cat(xs).numpy() for xs in zip(*per_lane)]


# ---------------------------------------------------------------- the split
@pytest.mark.parametrize("ngptot,nranks", [
    (1000, 3), (100, 8), (104, 8), (1, 4), (7, 7), (5000, 6), (327680, 2),
    (163841, 4)])
def test_rank_columns_and_pad_match_jax(ngptot, nranks):
    """The reference's split, (NGPTOTG-1)/NUMPROC+1 per rank with the
    remainder on the last (dwarf_cloudsc.F90:66-69), and the padding to a
    multiple of the mesh, as the JAX package computes them."""
    import jax

    for r in range(nranks):
        mine = dist.rank_columns(ngptot, nranks, r)
        theirs = jdist.rank_columns(ngptot, nranks, r)
        assert (mine.start, mine.stop) == (min(theirs.start, ngptot), theirs.stop), r
    if nranks <= LANES:
        assert dist.pad_columns(ngptot, dist.ColumnMesh(["cpu"] * nranks)) == \
            jdist.pad_columns(ngptot, jdist.column_mesh(jax.devices()[:nranks]))


def test_lane_slices_cover_the_columns_once(mesh):
    """The lanes' slices are consecutive and cover every column once;
    padded, every lane holds as many; ``shard_inputs`` gives each lane its
    slice, contiguous."""
    for ngptot in (100, 104, 3):
        s = dist.lane_slices(ngptot, mesh)
        assert s[0].start == 0 and s[-1].stop == ngptot
        assert all(a.stop == b.start for a, b in zip(s, s[1:]))
    padded = dist.pad_columns(100, mesh)
    assert {x.stop - x.start for x in dist.lane_slices(padded, mesh)} == {13}
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    whole = st.device_kernel_inputs(padded, dtype=torch.float64, device="cpu")
    for x, s in zip(dist.shard_inputs(whole, mesh), dist.lane_slices(padded, mesh)):
        assert x.pqs is None and x.pt.is_contiguous()
        assert torch.equal(x.paph, whole.paph[:, s])


def test_mesh_refuses_repeated_cards_and_too_many(monkeypatch):
    """CUDA lanes are distinct cards, and no more than the machine has; a
    repeated CPU lane is a lane."""
    with pytest.raises(ValueError, match="distinct cards"):
        dist.ColumnMesh(["cuda:0", "cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="3 lanes need 3 distinct cards"):
        dist.column_mesh("cuda", 3)
    assert [str(d) for d in dist.column_mesh("cuda", 2).lanes] == ["cuda:0", "cuda:1"]
    assert dist.column_mesh("cpu", 3).size == 3
    assert not dist.initialize(num_processes=1)


# ------------------------------------------------------- run_nl, run_tlad
@pytest.mark.parametrize("backend", ["kernels", "truth"])
def test_run_nl_mesh_matches_jax(jmesh, mesh, backend):
    """The fixture padded to 104 columns over 8 lanes, f64, each lane on its
    own columns, against the JAX package's run_nl on its 8-device mesh
    (``test_sharded_matches_single_device``, rtol 1e-10)."""
    n = dist.pad_columns(100, mesh)
    assert n == jdist.pad_columns(100, jmesh) == 104
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    st.ngptot = n
    out = run_nl(_lanes(st, n, mesh, standard=True), st.params, backend=backend,
                 mesh=mesh)
    assert len(out) == LANES
    padded = JState.load(FIXTURES / "input.h5", ngptot=n)
    ref = jrun_nl(jdist.shard_inputs(padded.kernel_inputs(), jmesh), padded.params)
    for name, a, b in zip(ref._fields, _joined(out), ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10, atol=1e-16,
                                   err_msg=name)


def test_run_nl_mesh_streams_match_one_lane(mesh):
    """The main path's stream contract over 8 lanes: each lane's streams
    are the one-lane run's columns of that lane, bit for bit."""
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    n = 104
    lanes = run_nl(_lanes(st, n, mesh), st.params, mesh=mesh)
    whole = run_nl(st.device_kernel_inputs(n, dtype=torch.float64, device="cpu"),
                   st.params)
    for name, parts, ref in zip(whole._fields, zip(*lanes), whole):
        assert torch.equal(torch.cat(parts, dim=-1), ref), name


def test_run_tlad_mesh_matches_jax(stores, jmesh, mesh):
    """The TL+AD unit on the standard contract, 64 columns x 9 levels, f64,
    over 8 lanes: each lane's outputs are the one-lane run's columns of that
    lane bit for bit, and the whole against the JAX package's run_tlad on
    its mesh (``test_run_tlad_xla_mesh``'s size) within 1e-10 of each
    field's max.  Element by element, one adjoint of 576 (pq) differs by
    1.2e-10 relative at 6.7e-13 absolute: the two packages' TL and AD, not
    the decomposition, which changes no bit."""
    jst, st = stores[9]
    n = 64
    res = run_tlad(_lanes(st, n, mesh, standard=True), st.params, lregcl=True,
                   backend="kernels", mesh=mesh)
    whole = run_tlad(st.device_inputs(n, dtype=torch.float64, device="cpu"),
                     st.params, lregcl=True, backend="kernels")
    jin = jst.device_kernel_inputs(n)
    ref = jrun_tlad(jdist.shard_inputs(jin, jmesh), jst.params, lregcl=True,
                    remat=False)
    for group, (mine, one, theirs) in enumerate(zip(zip(*res), whole, ref)):
        for name, a, b, c in zip(theirs._fields, _joined(mine), one, theirs):
            assert a.tobytes() == b.numpy().tobytes(), (group, name)
            c = np.asarray(c)
            assert np.abs(a - c).max() <= 1e-10 * np.abs(c).max(), (group, name)


def test_run_tlad_mesh_refuses_a_lane_on_another_device(mesh):
    st = Cloudsc2State.synthetic(ngptot=16, nlev=5)
    lanes = _lanes(st, 16, mesh, pqs=True)
    with pytest.raises(ValueError, match="8 lanes"):
        run_tlad(lanes[:3], st.params, mesh=mesh)
    with pytest.raises(TypeError, match="ColumnMesh"):
        run_nl(lanes, st.params, mesh=object())


# ------------------------------------------------------------ run_chunked
@pytest.mark.parametrize("variant,nlev,ngptot,chunk", [
    ("nl", 13, 2048, 1024), ("nl", 13, 2048, 2048), ("tlad", 9, 1024, 1024)])
def test_run_chunked_mesh_matches_jax(stores, jmesh, mesh, variant, nlev,
                                      ngptot, chunk):
    """Each lane generates its own share of every chunk at its global
    offset; the checksum over 8 lanes against the JAX package's on its
    8-device mesh and against one lane (rtol 1e-5 nl, 1e-4 tlad;
    ``test_run_chunked_mesh_invariant``)."""
    jst, st = stores[nlev]
    rtol = 1e-5 if variant == "nl" else 1e-4
    kw = dict(variant=variant, chunk=chunk, sublanes=1)
    n, s = run_chunked(st, ngptot, device="cpu", mesh=mesh, **kw)
    n1, s1 = run_chunked(st, ngptot, device="cpu", **kw)
    jn, js = jrun_chunked(jst, ngptot, interpret=True, mesh=jmesh, **kw)
    assert n == n1 == jn == ngptot
    np.testing.assert_allclose(s, js, rtol=rtol)
    np.testing.assert_allclose(s, s1, rtol=rtol)


def test_run_chunked_mesh_rounds_and_fuses(stores, mesh):
    """Chunks round to whole groups of 8·128 columns with 8 lanes (a
    sub-group chunk rounds up to one group), ``fused_gen`` to
    lcm(1024, 100) = 25,600; ``fused_gen`` equals regeneration bit for bit
    over two chunks of that period."""
    _, st = stores[13]
    kw = dict(variant="nl", sublanes=1, device="cpu", mesh=mesh)
    assert run_chunked(st, 1024, chunk=500, **kw)[0] == 1024
    fused = run_chunked(st, 2 * 25600, chunk=1024, fused_gen=True, **kw)
    regen = run_chunked(st, 2 * 25600, chunk=25600, **kw)
    assert fused == regen and fused[0] == 51200


def test_chunk_loop_mesh_keeps_one_accumulator_per_lane(stores, mesh):
    """``chunk_loop(mesh=)`` returns each lane's unread accumulator, on its
    lane; ``run_chunked`` reduces them once."""
    from cloudsc2jax_torch.drivers import chunk_loop

    _, st = stores[13]
    kw = dict(variant="nl", chunk=1024, sublanes=1, device="cpu", mesh=mesh)
    n, accs = chunk_loop(st, 2048, **kw)
    assert n == 2048 and len(accs) == LANES
    assert all(a.dim() == 0 and a.dtype == torch.float32 for a in accs)
    assert run_chunked(st, 2048, **kw)[1] == float(mesh.reduce(accs, "sum"))


# ------------------------------------------------------------- validation
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_validate_device_mesh_equals_one_lane(monkeypatch, mesh, dtype):
    """The statistics over 8 lanes equal the one-lane statistics of the
    same columns: MIN and MAX exactly, the sums to 1e-12 relative, the
    column count the global one; both verdicts the same."""
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    n = 300
    seen = []

    def record(errors, threshold=10.0, file=None):
        seen.append(errors)
        return all(e.passed(threshold) for e in errors.values())

    monkeypatch.setattr(tval, "print_validation", record)
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import unblock_outputs

    lanes = _lanes(st, n, mesh, dtype=dtype)
    out = [unblock_outputs(o, st.params) for o in run_nl(lanes, st.params, mesh=mesh)]
    whole = st.device_kernel_inputs(n, dtype=dtype, device="cpu")
    one = unblock_outputs(run_nl(whole, st.params), st.params)
    ref = FIXTURES / "reference.npz"
    assert st.validate_device(out, lanes, ref, threshold=1e4, mesh=mesh) == \
        st.validate_device(one, whole, ref, threshold=1e4)
    many, single = seen
    assert list(many) == list(single)
    for k in many:
        a, b = many[k], single[k]
        assert (a.ngptot, a.ndim, a.eps) == (b.ngptot, b.ndim, b.eps) == \
            (n, b.ndim, float(torch.finfo(dtype).eps))
        assert (a.zminval, a.zmaxval, a.zmaxerr) == (b.zminval, b.zmaxval, b.zmaxerr), k
        for f in ("zerrsum", "zsum"):
            x, y = getattr(a, f), getattr(b, f)
            assert abs(x - y) <= 1e-12 * max(abs(y), 1e-300), (k, f)


def test_validate_device_col_offset(monkeypatch):
    """A rank holding the global columns [137, 437) validates against the
    golden columns tiled from 137 and passes; tiled from 0 it does not (137
    is no multiple of the 100 stored columns)."""
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    monkeypatch.setattr(tval, "print_validation",
                        lambda e, threshold=10.0, file=None:
                        all(x.passed(threshold) for x in e.values()))
    from cloudsc2jax_torch.kernels.cloudsc2_kernel import unblock_outputs

    x = st.device_kernel_inputs(300, dtype=torch.float64, device="cpu", col_offset=137)
    out = unblock_outputs(run_nl(x, st.params), st.params)
    ref = FIXTURES / "reference.npz"
    assert st.validate_device(out, x, ref, col_offset=137)
    assert not st.validate_device(out, x, ref, col_offset=0)


# ------------------------------------------------ Taylor and adjoint tests
def test_taylor_and_adjoint_tests_mesh_equal_one_lane(stores, mesh):
    """Each lane blocks its own columns; the norms reduced with MAX equal
    the one-lane run's (nproma 1: the same blocks) to the plain versions'
    rounding by batch width, and the verdicts are the same."""
    _, st = stores[9]
    n = 64
    lanes = _lanes(st, n, mesh, standard=True)
    whole = st.device_inputs(n, dtype=torch.float64, device="cpu")
    tl8 = taylor_test(lanes, st.params, nproma=1, mesh=mesh)
    tl1 = taylor_test(whole, st.params, nproma=1)
    np.testing.assert_allclose(tl8.norms, tl1.norms, rtol=1e-9)
    assert (tl8.penalty, tl8.passed) == (tl1.penalty, tl1.passed)
    ad8 = adjoint_test(lanes, st.params, mesh=mesh)
    ad1 = adjoint_test(whole, st.params)
    assert ad8.passed == ad1.passed
    np.testing.assert_allclose(ad8.max_error, ad1.max_error, rtol=1e-6)


def test_dryrun_over_eight_cpu_lanes():
    """``dist.dryrun``: the NL step and the TL+AD unit over 8 lanes agree
    with one lane over the same columns."""
    worst = dist.dryrun(LANES, "cpu", ncol=16, nlev=9, dtype=torch.float64)
    assert set(worst) == {"nl", "tlad"} and max(worst.values()) <= 1e-10


# ----------------------------------------------------------------- timer
def test_timer_lanes_mirror_and_measure(capsys):
    """Lanes share one clock (``mirror`` rows) until each is re-timed on
    its own device (``measured`` rows)."""
    from cloudsc2jax_torch.timer import PerformanceTimer

    t = PerformanceTimer(["cpu"] * 3)
    t.start(3)
    t.thread_start(0)
    t.spmd_log(3, 301)
    t.thread_end(0)
    t.mirror_times(3)
    t.end()
    t.print_performance(100, 4, 301, gather=True)
    err = capsys.readouterr().err
    assert err.count("(mirror)") == 2 and "(measured)" not in err
    assert [int(line.split()[2]) for line in err.splitlines()[1:4]] == [101, 100, 100]
    st = Cloudsc2State.synthetic(ngptot=8, nlev=3)
    x = st.device_kernel_inputs(8, dtype=torch.float32, device="cpu")
    t.measure_device_lanes(lambda v: v.pt * 2, [x, x, x], calls_equivalent=2)
    t.print_performance(100, 4, 301)
    err = capsys.readouterr().err
    assert err.count("(measured)") == 3 and "(mirror)" not in err
