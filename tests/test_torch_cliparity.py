"""The CLI's golden writer, profiler and energy probe, and the write side of
``io`` and ``state`` behind them, against the JAX package.

``CLOUDSC2_WRITE_REFERENCE=1`` makes an ``nl`` run write ``reference.npz``
into the working directory; the JAX package's ``state.write_reference``,
fed the same outputs as numpy, must write the same datasets bit for bit,
and the JAX loaders must read the port's files.  The runs use the plain
versions on the CPU at the fixture's 100 columns.
"""

import json

import numpy as np
import pytest
import torch

from cloudsc2jax import io as jio
from cloudsc2jax.physics.cloudsc2 import Cloudsc2Outputs as JOutputs
from cloudsc2jax_torch import cli
from cloudsc2jax_torch import io as tio
from cloudsc2jax_torch import timer as ttimer
from cloudsc2jax_torch.errors import Abor1Error
from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Outputs
from cloudsc2jax_torch.state import Cloudsc2State

from conftest import FIXTURES


def _stores_equal(a, b):
    """Every dataset of two stores: the same names, dtypes, shapes, bits."""
    with jio.open_store(a) as fa, jio.open_store(b) as fb:
        assert sorted(fa.keys()) == sorted(fb.keys())
        for k in fa.keys():
            x, y = np.asarray(fa[k]), np.asarray(fb[k])
            assert (x.dtype, x.shape) == (y.dtype, y.shape), k
            assert x.tobytes() == y.tobytes(), k


def _run_writing(monkeypatch, tmp_path, argv):
    """A CLI run with CLOUDSC2_WRITE_REFERENCE=1 in ``tmp_path``; returns
    its exit code and the outputs it wrote from."""
    written = []
    write = Cloudsc2State.write_reference

    def spy(self, out, path):
        written.append(out)
        return write(self, out, path)

    monkeypatch.setattr(Cloudsc2State, "write_reference", spy)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CLOUDSC2_WRITE_REFERENCE", "1")
    rc = cli.main(argv + ["--device", "cpu"])
    monkeypatch.delenv("CLOUDSC2_WRITE_REFERENCE")
    (out,) = written
    return rc, out


@pytest.mark.parametrize("argv", [
    ["nl", "1", "100", "100", "--kernels"],
    ["nl", "1", "100", "100", "--kernels", "--dtype", "f32", "--threshold", "1e4"],
    ["nl", "1", "100", "100"],
])
def test_golden_file_equals_the_jax_writer(monkeypatch, tmp_path, state, argv):
    """The port's ``reference.npz`` against the JAX package's
    ``state.write_reference`` of the same outputs: every dataset's name,
    dtype, shape and bits; the JAX loader reads it back to the same fields."""
    rc, out = _run_writing(monkeypatch, tmp_path, argv)
    assert rc == 0
    mine = tmp_path / cli.WRITTEN_REFERENCE
    assert mine.is_file()
    theirs = tmp_path / "jax.npz"
    state.write_reference(
        JOutputs(**{k: v.numpy() for k, v in out._asdict().items()}), theirs)
    _stores_equal(mine, theirs)
    back = jio.load_reference_h5(mine)
    for k, v in jio.load_reference_h5(theirs).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_golden_file_validates_a_second_run(monkeypatch, tmp_path, capsys):
    """A second run over 300 columns validates against the written file
    with no flagged row, on the device path and on the host path."""
    rc, out = _run_writing(monkeypatch, tmp_path, ["nl", "1", "100", "100",
                                                   "--kernels"])
    assert rc == 0
    capsys.readouterr()
    rc = cli.main(["nl", "1", "300", "100", "--kernels", "--device", "cpu",
                   "--reference", str(tmp_path / cli.WRITTEN_REFERENCE)])
    err = capsys.readouterr().err
    assert rc == 0 and "TENDENCY_LOC_CLD" in err and "!!!!" not in err
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    assert st.validate(out, tmp_path / cli.WRITTEN_REFERENCE, quiet=True)
    assert not st.validate(out._replace(tenl_t=out.tenl_t * 1.001),
                           tmp_path / cli.WRITTEN_REFERENCE, quiet=True)


def test_host_validation_prints_the_jax_table(capsys, state, nl_outputs):
    """``state.validate`` on the host prints the JAX package's table for
    the same outputs against the same golden file, character for
    character."""
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    out = Cloudsc2Outputs(*(torch.from_numpy(np.array(x)) for x in nl_outputs))
    assert st.validate(out, FIXTURES / "reference.npz")
    mine = capsys.readouterr().err
    assert state.validate(nl_outputs, FIXTURES / "reference.h5")
    assert mine == capsys.readouterr().err


def test_golden_writer_refuses_fewer_columns(monkeypatch, tmp_path):
    """Fewer columns than the stored ``klon_file`` are refused, as the
    reference refuses NPROMA != KLON (array_state_mod.F90:264-268)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CLOUDSC2_WRITE_REFERENCE", "1")
    with pytest.raises(Abor1Error):
        cli.main(["nl", "1", "50", "50", "--kernels", "--device", "cpu"])
    assert not (tmp_path / cli.WRITTEN_REFERENCE).exists()


@pytest.mark.parametrize("suffix", [".npz", ".h5"])
def test_input_store_reads_back_through_jax(tmp_path, suffix):
    """``write_input_h5`` then the JAX package's ``load_input_h5``: the
    same fields and the same constant groups, run scalars and eta."""
    if suffix == ".h5":
        pytest.importorskip("h5py")
    raw, params = tio.synthetic_state(nlon=100, nlev=13)
    path = tmp_path / f"input{suffix}"
    tio.write_input_h5(path, raw, params)
    fields, jparams = jio.load_input_h5(path)
    for k, v in raw.items():
        assert fields[k].tobytes() == np.ascontiguousarray(
            np.moveaxis(v, -1, 0)).tobytes(), k
    for group in ("yomcst", "yoethf", "yrecldp", "yrephli"):
        mine = getattr(params, group).h5_items()
        theirs = getattr(jparams, group).h5_items()
        assert sorted(mine) == sorted(theirs), group
        for k, v in mine.items():
            np.testing.assert_array_equal(np.asarray(theirs[k]), np.asarray(v),
                                          err_msg=f"{group}.{k}")
    assert jparams.ptsphy == params.ptsphy
    np.testing.assert_array_equal(jparams.ceta, params.ceta)
    st = Cloudsc2State.load(path)
    assert st.klon_file == 100 and st.params == params


@pytest.mark.parametrize("suffix", [".npz", ".h5"])
def test_reference_store_matches_the_jax_writer(tmp_path, suffix):
    """``write_reference_h5`` of the same outputs writes the JAX package's
    datasets, placeholders included."""
    if suffix == ".h5":
        pytest.importorskip("h5py")
    rng = np.random.default_rng(7)
    outputs = {k: rng.standard_normal(f(11) + (30,))
               for k, f in tio.REFERENCE_FIELDS.items()}
    tio.write_reference_h5(tmp_path / f"mine{suffix}", outputs)
    jio.write_reference_h5(tmp_path / f"theirs{suffix}", outputs)
    _stores_equal(tmp_path / f"mine{suffix}", tmp_path / f"theirs{suffix}")


def test_qsat_matches_jax(state):
    """SATUR of the stored state against the JAX package's, f64, within 4
    ulp (each package's libm exp)."""
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    mine = st.qsat(torch.float64)
    assert tuple(mine.shape) == st.fields["PT"].shape
    np.testing.assert_allclose(mine.numpy(), np.asarray(state.qsat(np.float64)),
                               rtol=4 * np.finfo(np.float64).eps, atol=0)


def test_profile_leaves_a_trace(tmp_path, capsys):
    """``--profile DIR`` writes a Chrome trace of the run into DIR."""
    rc = cli.main(["nl", "1", "10", "10", "--device", "cpu", "--no-validate",
                   "--profile", str(tmp_path / "prof")])
    assert rc == 0
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert f"profile written to {trace}" in capsys.readouterr().err


def _counters(monkeypatch, tmp_path, cray=None, rapl=None):
    """Point the energy probe at files under ``tmp_path`` (absent unless a
    value is given)."""
    paths = {}
    for name, value in (("CRAY_ENERGY", cray), ("RAPL_ENERGY_UJ", rapl)):
        paths[name] = tmp_path / name
        if value is not None:
            paths[name].write_text(value)
        monkeypatch.setattr(ttimer, name, str(paths[name]))
    monkeypatch.setattr(ttimer, "CRAY_POWER", str(tmp_path / "no_power"))
    return paths


@pytest.mark.parametrize("counter", ["cray", "rapl"])
def test_energy_probe_reads_the_counters(monkeypatch, tmp_path, capsys, counter):
    """Cray's pm_counters first, then RAPL; the timer prints the energy
    used between its start and its table."""
    monkeypatch.setenv("EC_PMON", "1")
    if counter == "cray":
        paths = _counters(monkeypatch, tmp_path, cray="1000 J", rapl="5")
        later, name = "1250.5 J", "CRAY_ENERGY"
    else:
        paths = _counters(monkeypatch, tmp_path, rapl="2000000")
        later, name = "252500000", "RAPL_ENERGY_UJ"
    t = ttimer.PerformanceTimer("cpu")
    t.start(1)
    paths[name].write_text(later)
    t.thread_start(0)
    t.thread_log(0, 100)
    t.thread_end(0)
    t.end()
    t.print_performance(100, 1, 100)
    assert "EC_PMON: energy=250.5 J over " in capsys.readouterr().err
    monkeypatch.delenv("EC_PMON")
    assert ttimer.energy_probe() is None


@pytest.mark.parametrize("cray", ["10 J", None])
def test_ec_pmon_through_the_cli(monkeypatch, tmp_path, capsys, cray):
    """``EC_PMON=1`` on the CLI prints the energy line where a counter can
    be read; without one nothing is printed and nothing fails."""
    _counters(monkeypatch, tmp_path, cray=cray)
    monkeypatch.setenv("EC_PMON", "1")
    rc = cli.main(["nl", "1", "100", "100", "--device", "cpu", "--kernels"])
    err = capsys.readouterr().err
    assert rc == 0
    assert ("EC_PMON: energy=0.0 J over " in err) == (cray is not None)
    assert ("EC_PMON" in err) == (cray is not None)
