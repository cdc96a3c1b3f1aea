"""The truth path's level checkpoint and NPROMA blocks against the JAX
package's, on one synthetic store (100 columns, 13 levels) that both
packages load, f64.

* ``cloudsc2_vjp(remat=True)`` against ``remat=False`` and against JAX's
  ``cloudsc2_vjp(remat=True)``: every input adjoint within 1e-12 of its
  field's max (``tests/test_adjoint.py:60-78``), ldrain1d off and on (on,
  the precipitation evaporation reads the surface pressure, so the ``paph``
  adjoint carries a path that a level body capturing ``paph_sfc`` would
  lose; ``pt`` and ``paph`` are named in their own assertions);
* ``torch.func.jvp`` and plain autograd through ``remat_level=True`` equal
  to the runs without it;
* ``map_columns`` at ``nproma`` 25 and 33 (a partial last block) against
  the unblocked run (``tests/test_dist.py:98-116``, ``:202-216``);
* ``run_tlad(backend="truth", nproma=33)`` against the unblocked unit and
  against JAX's ``run_tlad(backend="xla", nproma=33)``.
"""

from functools import partial

import numpy as np
import pytest
import torch

from cloudsc2jax import io as jio
from cloudsc2jax.state import Cloudsc2State as JState
from cloudsc2jax_torch.convert import contract_from_numpy, params_from_jax
from cloudsc2jax_torch.drivers import map_columns, run_tlad
from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs, Cloudsc2Outputs, cloudsc2
from cloudsc2jax_torch.tlad import cloudsc2_ad, cloudsc2_vjp

TOL = 1e-12
NLEV = 13


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(JAX state, JAX inputs, port params, port inputs): the same numpy
    inputs in both packages."""
    raw, params = jio.synthetic_state(nlon=100, nlev=NLEV)
    path = tmp_path_factory.mktemp("remat") / "input.npz"
    jio.write_input_h5(path, raw, params)
    jstate = JState.load(path)
    jin = jstate.kernel_inputs()
    return jstate, jin, params_from_jax(jstate.params), contract_from_numpy(jin)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _seeds(out):
    rng = np.random.default_rng(3)
    return [rng.standard_normal(tuple(y.shape)) for y in out]


@pytest.mark.parametrize("ldrain1d", [False, True])
def test_vjp_remat_matches_stored_and_jax(case, ldrain1d):
    from cloudsc2jax.tlad import cloudsc2_vjp as jvjp

    jstate, jin, tp, tin = case
    out, vjp_stored = cloudsc2_vjp(tin, tp, ldrain1d=ldrain1d)
    _, vjp_remat = cloudsc2_vjp(tin, tp, ldrain1d=ldrain1d, remat=True)
    seeds = _seeds(out)
    ybar = Cloudsc2Outputs(*(torch.from_numpy(s) for s in seeds))
    (stored,) = vjp_stored(ybar)
    (remat,) = vjp_remat(ybar)
    jout, jfn = jvjp(jin, jstate.params, ldrain1d=ldrain1d, remat=True)
    (theirs,) = jfn(type(jout)(*seeds))
    for name, a, b, c in zip(Cloudsc2Inputs._fields, remat, stored, theirs):
        assert _rel(a, b) < TOL, name
        assert _rel(a, c) < TOL, name
    # the adjoints a captured tensor would cut, by name
    assert _rel(remat.pt, stored.pt) < TOL and np.abs(stored.pt.numpy()).max() > 0
    assert _rel(remat.paph, stored.paph) < TOL and _rel(remat.paph, theirs.paph) < TOL
    assert np.abs(stored.paph.numpy()).max() > 0


def test_cloudsc2_ad_remat_matches_stored(case):
    _, _, tp, tin = case
    out = cloudsc2(tin, tp)
    ybar = Cloudsc2Outputs(*(torch.from_numpy(s) for s in _seeds(out)))
    _, stored = cloudsc2_ad(tin, ybar, tp)
    _, remat = cloudsc2_ad(tin, ybar, tp, remat=True)
    for name, a, b in zip(Cloudsc2Inputs._fields, remat, stored):
        assert _rel(a, b) < TOL, name


@pytest.mark.parametrize("lregcl", [False, True])
def test_jvp_and_autograd_through_remat(case, lregcl):
    """``remat_level=True`` under ``torch.func.jvp`` and under plain
    autograd gives what the loop without it gives."""
    _, _, tp, tin = case
    d = Cloudsc2Inputs(*(0.01 * x for x in tin))
    f = partial(cloudsc2, params=tp, lregcl=lregcl, ldrain1d=True)
    out, dout = torch.func.jvp(f, (tin,), (d,))
    out_r, dout_r = torch.func.jvp(partial(f, remat_level=True), (tin,), (d,))
    for name, a, b in zip(Cloudsc2Outputs._fields, (*out_r, *dout_r), (*out, *dout)):
        assert _rel(a, b) < TOL, name

    grads = []
    for remat in (False, True):
        x = Cloudsc2Inputs(*(t.clone().requires_grad_() for t in tin))
        y = f(x, remat_level=remat)
        sum((o * s).sum() for o, s in zip(y, dout)).backward()
        grads.append([t.grad for t in x])
    for name, a, b in zip(Cloudsc2Inputs._fields, *grads):
        assert _rel(b, a) < TOL, name


@pytest.mark.parametrize("nproma", [25, 33])
def test_map_columns_matches_unblocked(case, nproma):
    _, _, tp, tin = case
    f = partial(cloudsc2, params=tp)
    ref = f(tin)
    out = map_columns(f, tin, nproma)
    assert type(out) is Cloudsc2Outputs
    for name, a, b in zip(out._fields, out, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=1e-18,
                                   err_msg=name)


def test_map_columns_keeps_the_tree():
    """Tuples and NamedTuples come back as they went in, ``None`` stays
    ``None``, and a partial block's padding is replicas of column 0."""
    x = torch.arange(10.0).reshape(5, 2)
    seen = []

    def fn(tree):
        seen.append(tree[0][:, 0].tolist())
        return (tree[0] * 2, None, Cloudsc2Outputs(*([tree[1]] * 10)))

    out = map_columns(fn, (x, x[:, 0]), 2)
    assert seen == [[0.0, 2.0], [4.0, 6.0], [8.0, 0.0]]
    assert torch.equal(out[0], 2 * x) and out[1] is None
    assert type(out[2]) is Cloudsc2Outputs and torch.equal(out[2].pclc, x[:, 0])


def test_run_tlad_truth_nproma_matches_unblocked_and_jax(case):
    from cloudsc2jax.drivers import run_tlad as jrun_tlad

    jstate, jin, tp, tin = case
    blocked = run_tlad(tin, tp, backend="truth", nproma=33)
    whole = run_tlad(tin, tp, backend="truth", remat=False)
    theirs = jrun_tlad(jin, jstate.params, backend="xla", nproma=33)
    for mine, ref, jax_side in zip(blocked, whole, theirs):
        assert type(mine) is type(ref)
        for name, a, b, c in zip(mine._fields, mine, ref, jax_side):
            assert _rel(a, b) < TOL, name
            assert _rel(a, c) < TOL, name
