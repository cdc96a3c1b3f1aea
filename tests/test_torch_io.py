"""The port's I/O, constants and parameter hand-over against the JAX package.

The ``.npz`` fixtures are copies of the ``.h5`` fixtures for machines
without h5py; both packages must read the same fields and constants from
them, and build the same synthetic state from the same seed.
"""

import dataclasses

import h5py
import numpy as np
import pytest
import torch

from cloudsc2jax import io as jio
from cloudsc2jax_torch import io as tio
from cloudsc2jax_torch.constants import Params
from cloudsc2jax_torch.convert import inputs_from_numpy, params_from_jax

from conftest import FIXTURES


@pytest.mark.parametrize("name", ["input", "reference", "reference_ldrain1d"])
def test_npz_fixture_equals_h5_bit_for_bit(name):
    with h5py.File(FIXTURES / f"{name}.h5", "r") as f, \
            np.load(FIXTURES / f"{name}.npz") as z:
        assert sorted(f.keys()) == sorted(z.files)
        for k in f.keys():
            a, b = np.asarray(f[k]), z[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k


def test_load_input_npz_matches_jax_h5():
    fields, params = tio.load_input_h5(FIXTURES / "input.npz")
    jfields, jparams = jio.load_input_h5(FIXTURES / "input.h5")
    assert sorted(fields) == sorted(jfields)
    for k in fields:
        assert fields[k].tobytes() == jfields[k].tobytes(), k
    assert dataclasses.asdict(params) == dataclasses.asdict(jparams)


def test_load_reference_npz_matches_jax_h5():
    for name in ("reference", "reference_ldrain1d"):
        ref = tio.load_reference_h5(FIXTURES / f"{name}.npz", ngptot=250)
        jref = jio.load_reference_h5(FIXTURES / f"{name}.h5", ngptot=250)
        assert sorted(ref) == sorted(jref)
        for k in ref:
            np.testing.assert_array_equal(ref[k], jref[k], err_msg=k)


def test_params_from_jax_equals_npz_params(state):
    """The JAX Params carried across equal the port's own, loaded from the
    .npz copy of the same input, field by field."""
    _, own = tio.load_input_h5(FIXTURES / "input.npz")
    carried = params_from_jax(state.params)
    assert isinstance(carried, Params)
    for group in dataclasses.fields(Params):
        assert getattr(carried, group.name) == getattr(own, group.name), group.name


def test_synthetic_state_matches_jax():
    """Same seed, same generator: the two packages' synthetic states agree
    (qsat comes from each package's own SATUR in float64, so the humidity
    may differ in the last bits)."""
    fields, params = tio.synthetic_state(nlon=37, nlev=29, seed=5)
    jfields, jparams = jio.synthetic_state(nlon=37, nlev=29, seed=5)
    assert dataclasses.asdict(params) == dataclasses.asdict(jparams)
    for k in fields:
        np.testing.assert_allclose(fields[k], jfields[k], rtol=1e-14, atol=0,
                                   err_msg=k)


def test_expand_columns_matches_jax():
    fields, _ = tio.load_input_h5(FIXTURES / "input.npz")
    raw = {k: np.ascontiguousarray(np.moveaxis(v, 0, -1)) for k, v in fields.items()}
    for columns_first in (False, True):
        mine = tio.expand_columns(raw, 333, columns_first=columns_first)
        theirs = jio.expand_columns(raw, 333, columns_first=columns_first)
        for k in mine:
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


def test_inputs_from_numpy_is_levels_major(state):
    inputs = state.kernel_inputs()
    lm = inputs_from_numpy(inputs, dtype=torch.float32)
    for name, x in zip(lm._fields, lm):
        assert x.dtype == torch.float32 and x.is_contiguous()
        np.testing.assert_array_equal(
            x.numpy(), np.asarray(getattr(inputs, name), np.float32).T,
            err_msg=name)


def test_h5_to_npz_roundtrip(tmp_path):
    dst = tmp_path / "input.npz"
    tio.h5_to_npz(FIXTURES / "input.h5", dst)
    with np.load(dst) as a, np.load(FIXTURES / "input.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
