"""The port's native host shim (``cloudsc2jax_torch.native``) against the
JAX package's ``tests/test_native.py``, and where it is used: the core id of
a CPU lane, the energy probe, ``io.expand_columns`` (equal to the JAX
package's bit for bit).  Without a compiler or a library every entry point
keeps the JAX package's fallback, and ``expand_columns`` tiles with numpy
to the same bits."""

import numpy as np
import pytest

from cloudsc2jax import io as jio
from cloudsc2jax_torch import io as tio
from cloudsc2jax_torch import native, timer
from cloudsc2jax_torch.native import HostInfo, hostinfo

from conftest import FIXTURES


@pytest.fixture
def without_library(monkeypatch):
    """A shim whose build fails, as on a host without ``g++``."""
    def no_compiler():
        raise OSError("no g++")

    monkeypatch.setattr(native, "build", no_compiler)
    shim = HostInfo()
    monkeypatch.setattr(native, "hostinfo", shim)
    return shim


def test_sched_getcpu():
    cpu = hostinfo.sched_getcpu()
    assert isinstance(cpu, int) and cpu >= -1
    assert cpu >= 0 or not hostinfo.available


def test_monotonic_ns_advances():
    a = hostinfo.monotonic_ns()
    b = hostinfo.monotonic_ns()
    assert b >= a > 0


def test_expand_matches_numpy_tile():
    rng = np.random.default_rng(0)
    src = rng.standard_normal((100, 137))
    dst = np.empty((1024, 137))
    if not hostinfo.expand_f64(src, dst):
        pytest.skip("native lib unavailable")
    np.testing.assert_array_equal(dst, np.tile(src, (11, 1))[:1024])
    with pytest.raises(ValueError):
        hostinfo.expand_f64(src, np.empty((1024, 136)))


def test_library_is_built_under_the_checkout():
    path = native.library_path()
    assert path.parts[-5:-2] == ("build", "cloudsc2jax_torch", "native")
    if hostinfo.available:
        assert path.is_file()


def test_fallbacks_without_a_library(without_library):
    assert not without_library.available
    assert without_library.sched_getcpu() == -1
    assert without_library.energy_uj() == -1
    assert without_library.monotonic_ns() > 0
    assert without_library.expand_f64(np.zeros((3, 2)), np.empty((5, 2))) is False


@pytest.mark.parametrize("columns_first", [False, True])
@pytest.mark.parametrize("shim", ["built", "fallback"])
def test_expand_columns_matches_jax_bit_for_bit(request, columns_first, shim):
    if shim == "fallback":
        request.getfixturevalue("without_library")
    fields, _ = tio.load_input_h5(FIXTURES / "input.npz")
    raw = {k: np.ascontiguousarray(np.moveaxis(v, 0, -1)) for k, v in fields.items()}
    mine = tio.expand_columns(raw, 333, columns_first=columns_first)
    theirs = jio.expand_columns(raw, 333, columns_first=columns_first)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert mine[k].shape == theirs[k].shape and mine[k].flags["C_CONTIGUOUS"], k
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


def test_timer_reads_the_shim(monkeypatch):
    """A CPU lane's core id is ``sched_getcpu``; ``EC_PMON=1`` reads the
    shim's energy counter first."""
    monkeypatch.setattr(native.hostinfo, "sched_getcpu", lambda: 5)
    t = timer.PerformanceTimer("cpu")
    t.start(1)
    assert t._lanes[0].core_id == 5
    monkeypatch.setenv("EC_PMON", "1")
    monkeypatch.setattr(native.hostinfo, "energy_uj", lambda: 2_500_000)
    probe = timer.energy_probe()
    assert probe["energy_j"] == 2.5 and np.isnan(probe["power_w"])
