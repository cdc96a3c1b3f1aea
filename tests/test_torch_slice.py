"""The port's NL main path as a whole against the JAX package.

The slice: device expansion straight into the kernel layout, the sweep
through ``drivers.run_nl``, validation on the device, the CLI, and the
rule that the port never imports JAX.  On the CPU the sweep runs the
kernel's plain version.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import cloudsc2jax.validate as jval
from cloudsc2jax.drivers import run_nl as jrun_nl
from cloudsc2jax_torch import cli
from cloudsc2jax_torch import validate as tval
from cloudsc2jax_torch.convert import inputs_from_numpy
from cloudsc2jax_torch.drivers import run_nl
from cloudsc2jax_torch.kernels.cloudsc2_kernel import unblock_outputs
from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Outputs
from cloudsc2jax_torch.state import Cloudsc2State
from cloudsc2jax_torch.timer import PerformanceTimer

from conftest import FIXTURES

NCOL = 300


@pytest.fixture(scope="module")
def tstate():
    return Cloudsc2State.load(FIXTURES / "input.npz")


@pytest.fixture(scope="module")
def jax_inputs_300(state):
    return state.device_kernel_inputs(NCOL)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_device_kernel_inputs_match_blockify(state, tstate, dtype):
    """On-device cyclic expansion into (nlev[+1], ncol) equals the JAX
    blocked layout (blockify_columns, one sublane) reshaped and cut to
    300 columns, bit for bit.  The port expands no PQS (the sweep computes
    qsat itself); ``kernel_inputs``' PQS is each package's own SATUR of the
    same cast fields, and the two libm exp differ by up to 3 ulp there."""
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    mine = tstate.device_kernel_inputs(NCOL, dtype=tdtype, device="cpu")
    blk = state.device_kernel_inputs(NCOL, dtype=dtype, blocked_sublanes=1)
    assert mine.pqs is None
    for name, a, b in zip(mine._fields, mine, blk):
        b = np.asarray(b).reshape(b.shape[0], -1)[:, :NCOL]
        if name == "pqs":
            pqs = tstate.kernel_inputs(dtype=tdtype).pqs
            assert pqs.dtype == tdtype and tuple(pqs.shape) == (b.shape[0], 100)
            eps = np.finfo(dtype).eps
            np.testing.assert_allclose(pqs.numpy(), b[:, :100], rtol=4 * eps,
                                       atol=0)
            continue
        assert a.dtype == tdtype and a.is_contiguous(), name
        assert tuple(a.shape) == b.shape, name
        assert a.numpy().tobytes() == b.tobytes(), name


def test_run_nl_matches_jax_xla(tstate, state, jax_inputs_300):
    ref = jrun_nl(jax_inputs_300, state.params, backend="xla")
    out = unblock_outputs(run_nl(tstate.device_kernel_inputs(
        NCOL, dtype=torch.float64, device="cpu"), tstate.params), tstate.params)
    for name, a, b in zip(out._fields, out, ref):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a.numpy() - b).max() / scale < 1e-12, name


def _captured(monkeypatch, module):
    seen = {}

    def record(errors, threshold=10.0, file=None):
        seen.update(errors)
        return all(e.passed(threshold) for e in errors.values())

    monkeypatch.setattr(module, "print_validation", record)
    return seen


def test_validate_device_matches_jax(monkeypatch, state, jax_inputs_300):
    """Both packages' device validation of the same outputs give the same
    statistics: the same fields, and every number to 1e-12."""
    out = jrun_nl(jax_inputs_300, state.params)
    theirs = _captured(monkeypatch, jval)
    assert state.validate_device(out, jax_inputs_300,
                                 FIXTURES / "reference.h5")
    mine = _captured(monkeypatch, tval)
    tout = Cloudsc2Outputs(*(torch.from_numpy(np.array(x)) for x in out))
    tin = inputs_from_numpy(jax_inputs_300)
    tst = Cloudsc2State.load(FIXTURES / "input.npz")
    assert tst.validate_device(tout, tin, FIXTURES / "reference.npz")
    assert list(mine) == list(theirs)
    for k in mine:
        a, b = mine[k], theirs[k]
        assert (a.name, a.ndim, a.ngptot, a.eps) == (b.name, b.ndim, b.ngptot, b.eps)
        for f in ("zminval", "zmaxval", "zmaxerr", "zerrsum", "zsum"):
            x, y = getattr(a, f), getattr(b, f)
            assert abs(x - y) <= 1e-12 * max(abs(y), 1e-300), (k, f, x, y)


def test_validate_device_flags_a_wrong_field(tstate):
    inputs = tstate.device_kernel_inputs(NCOL, dtype=torch.float64, device="cpu")
    out = unblock_outputs(run_nl(inputs, tstate.params), tstate.params)
    assert tstate.validate_device(out, inputs, FIXTURES / "reference.npz",
                                  quiet=True)
    bad = out._replace(tenl_t=out.tenl_t * (1.0 + 1e-12))
    assert not tstate.validate_device(bad, inputs, FIXTURES / "reference.npz",
                                      quiet=True)


def test_output_dict_shapes(tstate):
    inputs = tstate.device_kernel_inputs(NCOL, dtype=torch.float32, device="cpu")
    res = tstate.output_dict(unblock_outputs(run_nl(inputs, tstate.params),
                                             tstate.params))
    assert res["TENDENCY_LOC_CLD"].shape == (NCOL, 5, 137)
    assert res["PFPLSL"].shape == (NCOL, 138)
    assert res["PLUDE"].shape == (NCOL, 137)
    np.testing.assert_array_equal(res["PLUDE"][100:200], res["PLUDE"][:100])
    assert all(v.dtype == np.float64 for v in res.values())


@pytest.mark.parametrize("argv", [
    ["nl", "1", "300", "100", "--dtype", "f64", "--device", "cpu"],
    ["nl", "1", "300", "100", "--dtype", "f32", "--device", "cpu",
     "--threshold", "10000"],
])
def test_cli_nl_validates(argv, capsys):
    assert cli.main(argv) == 0
    err = capsys.readouterr().err
    assert "TENDENCY_LOC_T" in err and "!!!!" not in err


def test_cli_rejects_more_than_one_device():
    with pytest.raises(SystemExit):
        cli.main(["nl", "2", "300", "100", "--device", "cpu"])


def test_cli_fails_on_a_loose_threshold_miss(capsys):
    """f32 does not meet the f64 budget of 10 eps: the CLI must say so."""
    rc = cli.main(["nl", "1", "300", "100", "--dtype", "f32", "--device", "cpu"])
    assert rc == 1
    assert "!!!!" in capsys.readouterr().err


def test_timer_table(capsys):
    timer = PerformanceTimer("cpu")
    timer.start(1)
    timer.thread_start(0)
    timer.thread_log(0, 1000)
    timer.thread_end(0)
    timer.end()
    rate = timer.print_performance(100, 10, 1000)
    err = capsys.readouterr().err
    assert "MFlops/s" in err and "total" in err and rate > 0


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import cloudsc2jax_torch, cloudsc2jax_torch.cli\n"
        "import cloudsc2jax_torch.kernels.cloudsc2_kernel\n"
        "import cloudsc2jax_torch.drivers, cloudsc2jax_torch.state\n"
        "import cloudsc2jax_torch.convert, cloudsc2jax_torch.kernels.build\n"
        "import cloudsc2jax_torch.ops, cloudsc2jax_torch.kernels.tlad_kernel\n"
        "import cloudsc2jax_torch.kernels.emit\n"
        "import cloudsc2jax_torch.kernels.experiments\n"
        "import cloudsc2jax_torch.kernel_ab, cloudsc2jax_torch.bw_probe\n"
        "import cloudsc2jax_torch.encoding_study, cloudsc2jax_torch.tlad\n"
        "import cloudsc2jax_torch.bench, cloudsc2jax_torch.io\n"
        "import cloudsc2jax_torch.timer, cloudsc2jax_torch.validate\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'cloudsc2jax.'))"
        " or m == 'cloudsc2jax' for m in sys.modules), sorted(sys.modules)\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=FIXTURES.parents[1])
