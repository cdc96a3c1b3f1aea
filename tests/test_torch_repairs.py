"""Repairs of the port against the JAX package's drivers, state and cache.

Each test holds one repair on the CPU: ``run_nl`` returns the kernel's
streams by default and has the reference's three backends; the CLI
assembles the ``(ncol, nlev)`` contract once, after its timed loop; a TL+AD
unit computes the pre-kernel pass once; ``device_kernel_inputs`` takes
``col_offset``; the build hash covers the compiler and per-library nvcc
flags (the ``-fmad=false`` TL build that the CUDA-gated parity test and
``chip_smoke.py`` hold to the reference's 1e-6).
"""

import types

import numpy as np
import pytest
import torch

from cloudsc2jax.drivers import run_nl as jrun_nl
from cloudsc2jax_torch import cli, drivers
from cloudsc2jax_torch.kernels import build
from cloudsc2jax_torch.kernels import cloudsc2_kernel as kmod
from cloudsc2jax_torch.kernels import tlad_kernel as tk
from cloudsc2jax_torch.state import Cloudsc2State

from conftest import FIXTURES

NCOL = 100


@pytest.fixture(scope="module")
def tstate():
    return Cloudsc2State.load(FIXTURES / "input.npz")


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-300)


def test_run_nl_returns_the_kernels_streams(tstate):
    """The default backend is the main path's stream contract: the 8
    levels-major streams of the sweep, with no assembly."""
    inputs = tstate.device_kernel_inputs(NCOL, dtype=torch.float64, device="cpu")
    got = drivers.run_nl(inputs, tstate.params)
    ref = kmod.cloudsc2_nl(inputs, tstate.params)
    assert type(got) is kmod.Cloudsc2StreamOutputs
    for name, a, b in zip(got._fields, got, ref):
        assert tuple(a.shape) == (137, NCOL), name
        assert torch.equal(a, b), name


@pytest.mark.parametrize("backend", ["kernels", "truth"])
def test_run_nl_backends_match_jax(state, tstate, backend):
    """``"kernels"`` (the sweep on the standard contract, JAX's ``pallas``)
    and ``"truth"`` (JAX's ``xla``) against the JAX package's run_nl on the
    fixture, in f64."""
    ref = jrun_nl(state.device_kernel_inputs(NCOL), state.params, backend="xla")
    out = drivers.run_nl(
        tstate.device_inputs(NCOL, dtype=torch.float64, device="cpu"),
        tstate.params, backend=backend)
    for name, a, b in zip(out._fields, out, ref):
        assert tuple(a.shape) == np.shape(b), name
        assert _rel(a.numpy(), b) < 1e-12, (backend, name)
    with pytest.raises(ValueError, match="backend"):
        drivers.run_nl(out, tstate.params, backend="pallas")


def test_cli_nl_assembles_the_contract_once(monkeypatch, capsys):
    """``nl --kernels`` times the stream contract and unblocks once, after
    the loop, for the validation; without ``--kernels`` it runs the truth
    path, and both validate against the golden file."""
    calls = {"unblock": 0, "truth": 0, "sweep": 0}
    unblock, truth, sweep = kmod.unblock_outputs, drivers.cloudsc2, drivers.cloudsc2_nl

    def counted(key, fn):
        def run(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(kmod, "unblock_outputs", counted("unblock", unblock))
    monkeypatch.setattr(drivers, "cloudsc2", counted("truth", truth))
    monkeypatch.setattr(drivers, "cloudsc2_nl", counted("sweep", sweep))
    argv = ["nl", "1", "150", "100", "--dtype", "f64", "--device", "cpu",
            "--repeat", "3"]
    assert cli.main(argv + ["--kernels"]) == 0
    assert calls == {"unblock": 1, "truth": 0, "sweep": 3}
    assert cli.main(argv) == 0
    assert calls == {"unblock": 1, "truth": 3, "sweep": 3}
    err = capsys.readouterr().err
    assert "TENDENCY_LOC_T" in err and "!!!!" not in err


@pytest.mark.parametrize("backend", ["streams", "kernels"])
def test_run_tlad_computes_one_prelude_per_unit(monkeypatch, backend):
    """Both sweeps of a unit share one pre-kernel pass (the TL and AD
    wrappers, the forward-checkpoint sweep and the plain versions take it
    from the driver)."""
    st = Cloudsc2State.synthetic(ngptot=6, nlev=5, seed=3)
    calls = []
    prelude = kmod.kernel_prelude

    def counted(*args, **kwargs):
        calls.append(1)
        return prelude(*args, **kwargs)

    for module in (kmod, tk, drivers):
        monkeypatch.setattr(module, "kernel_prelude", counted)
    if backend == "streams":
        inputs = st.device_kernel_inputs(6, dtype=torch.float64, device="cpu",
                                         pqs=True)
    else:
        inputs = st.device_inputs(6, dtype=torch.float64, device="cpu")
    out, dout, adj = drivers.run_tlad(inputs, st.params, backend=backend)
    assert len(calls) == 1
    assert all(torch.isfinite(x).all() for x in (*out, *dout, *adj))


@pytest.mark.parametrize("col_offset", [0, 37, 100, 251])
def test_device_kernel_inputs_take_a_column_offset(state, tstate, col_offset):
    """Column i holds stored column (col_offset + i) % 100, as
    ``cloudsc2jax.state.device_kernel_inputs(col_offset=...)`` tiles it;
    pqs is each package's own SATUR of the same fields (up to 4 ulp)."""
    ncol = 130
    mine = tstate.device_kernel_inputs(ncol, dtype=torch.float64, device="cpu",
                                       pqs=True, col_offset=col_offset)
    theirs = state.device_kernel_inputs(ncol, dtype=np.float64, levels_major=True,
                                        col_offset=col_offset)
    for name, a, b in zip(mine._fields, mine, theirs):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        if name == "pqs":
            np.testing.assert_allclose(a.numpy(), b, rtol=4 * np.finfo(np.float64).eps,
                                       atol=0)
        else:
            assert a.numpy().tobytes() == b.tobytes(), name
    shifted = tstate.device_kernel_inputs(ncol - 1, dtype=torch.float64,
                                          device="cpu", col_offset=col_offset + 1)
    assert torch.equal(shifted.pt, mine.pt[:, 1:])


def test_build_hash_covers_the_compiler(monkeypatch):
    """A library built by one toolkit is not loaded for another: the hash
    takes the text of ``nvcc --version``, which is read once per process."""
    runs = []

    def fake_run(cmd, **kwargs):
        runs.append(cmd)
        return types.SimpleNamespace(stdout=version)

    monkeypatch.setattr(build, "nvcc_path", lambda: "/toolkit/bin/nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    dirs = []
    for version in ("Cuda compilation tools, release 12.9, V12.9.86",
                    "Cuda compilation tools, release 13.0, V13.0.48"):
        monkeypatch.setattr(build, "_NVCC_VERSION", [])
        dirs.append(build._build_dir("cloudsc2_nl"))
        assert build._build_dir("cloudsc2_nl") == dirs[-1]
    assert dirs[0] != dirs[1]
    assert runs == [["/toolkit/bin/nvcc", "--version"]] * 2


def test_build_hash_covers_per_library_flags():
    """``build.variant`` gives one library a build of its own (the TL
    kernel under ``-fmad=false``) and leaves the others and, after the
    block, the library itself as they were; defines a build names itself
    are not overridden."""
    plain = build._build_dir(*build._key("cloudsc2_tl_din"))
    other = build._build_dir(*build._key("cloudsc2_tl"))
    with build.variant("cloudsc2_tl_din", flags=("-fmad=false",)):
        key = build._key("cloudsc2_tl_din")
        assert key == ("cloudsc2_tl_din", (), ("-fmad=false",))
        assert build._build_dir(*key) != plain
        assert build._build_dir(*build._key("cloudsc2_tl")) == other
        assert "-fmad=false" in build._command(*key)
        assert build._key(("cloudsc2_tl_din", ("X=1",))) == (
            "cloudsc2_tl_din", ("X=1",), ())
    assert build._key("cloudsc2_tl_din") == ("cloudsc2_tl_din", (), ())
    assert build._build_dir(*build._key("cloudsc2_tl_din")) == plain
