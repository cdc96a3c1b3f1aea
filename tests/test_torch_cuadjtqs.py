"""The port's saturation adjustment (``cloudsc2jax_torch.physics.cuadjtqs``)
against the JAX package's on the same numpy inputs from a seed, f64.

* ``cuadjtqs`` for KCALL 0, 1, 2, 4 and an unknown value (which behaves as
  0) within 1e-13 of each output's max, with columns on both sides of RTT,
  sub- and supersaturated, and a clamp at qsat = 0.5 (near-vacuum pressure);
* ``cuadjtqs_tl`` and ``cuadjtqs_ad`` against JAX's, within 1e-13;
* the TL/AD pair's own checks of ``tests/test_physics_units.py:125-158`` on
  the port: the Taylor residual of the tangent and the dot-product identity
  of the adjoint;
* the clamps' derivative at a tie, where ``cond`` is exactly 0 (KCALL 1 and
  2): JAX's, split evenly.
"""

import importlib

import numpy as np
import pytest
import torch

from cloudsc2jax.constants import Params as JParams
from cloudsc2jax_torch.convert import params_from_jax

jcu = importlib.import_module("cloudsc2jax.physics.cuadjtqs")
tcu = importlib.import_module("cloudsc2jax_torch.physics.cuadjtqs")

TOL = 1e-13
KCALLS = [0, 1, 2, 4, 3]


@pytest.fixture(scope="module")
def params():
    jp = JParams.ifs_defaults(ceta=np.linspace(0.005, 1.0, 10))
    return jp, params_from_jax(jp)


@pytest.fixture(scope="module")
def state():
    """psp, t, q and their increments: 64 random columns, then a column
    at near-vacuum pressure (qsat clamped at 0.5) and one exactly at RTT."""
    rng = np.random.default_rng(7)
    n = 64
    psp = np.concatenate([8.0e4 + 1.0e4 * rng.random(n), [5.0, 8.5e4]])
    t = np.concatenate([250.0 + 40.0 * rng.random(n), [260.0, 273.16]])
    q = np.concatenate([5.0e-3 * rng.random(n), [0.3, 0.01]])
    return psp, t, q, 0.01 * psp, 0.01 * t, 0.01 * q


def _rel(mine, theirs):
    mine, theirs = np.asarray(mine), np.asarray(theirs)
    return np.abs(mine - theirs).max() / max(np.abs(theirs).max(), 1e-300)


def _j(*xs):
    import jax.numpy as jnp

    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("kcall", KCALLS)
def test_cuadjtqs_matches_jax(params, state, kcall):
    jp, tp = params
    psp, t, q = state[:3]
    theirs = jcu.cuadjtqs(*_j(psp, t, q), jp, kcall=kcall)
    mine = tcu.cuadjtqs(*_t(psp, t, q), tp, kcall=kcall)
    for a, b in zip(mine, theirs):
        assert a.dtype == torch.float64
        assert _rel(a.numpy(), b) <= TOL


@pytest.mark.parametrize("kcall", KCALLS)
def test_cuadjtqs_tl_and_ad_match_jax(params, state, kcall):
    jp, tp = params
    (_, jd), (_, td) = (jcu.cuadjtqs_tl(*_j(*state), jp, kcall=kcall),
                        tcu.cuadjtqs_tl(*_t(*state), tp, kcall=kcall))
    for a, b in zip(td, jd):
        assert _rel(a.numpy(), b) <= TOL
    seeds = [np.asarray(x) for x in jd]
    _, ja = jcu.cuadjtqs_ad(*_j(*state[:3], *seeds), jp, kcall=kcall)
    _, ta = tcu.cuadjtqs_ad(*_t(*state[:3], *seeds), tp, kcall=kcall)
    for a, b in zip(ta, ja):
        assert _rel(a.numpy(), b) <= TOL


@pytest.mark.parametrize("kcall", [0, 1, 2])
def test_cuadjtqs_tl_ad_consistency(params, kcall):
    """``tests/test_physics_units.py:125-158`` on the port: the tangent's
    Taylor residual is second order in the step, and the adjoint is the
    tangent's transpose to 1e-12."""
    tp = params[1]
    rng = np.random.default_rng(7)
    n = 64
    psp, t, q = _t(8.0e4 + 1.0e4 * rng.random(n), 250.0 + 40.0 * rng.random(n),
                   5.0e-3 * rng.random(n))
    dp, dt_, dq = 0.01 * psp, 0.01 * t, 0.01 * q
    (t2, q2), (jt, jq) = tcu.cuadjtqs_tl(psp, t, q, dp, dt_, dq, tp, kcall=kcall)
    lam = 1e-5
    t2p, q2p = tcu.cuadjtqs(psp + lam * dp, t + lam * dt_, q + lam * dq, tp,
                            kcall=kcall)
    for pert, base, jac in ((t2p, t2, jt), (q2p, q2, jq)):
        resid = float(((pert - base) - lam * jac).abs().max())
        scale = lam * float((lam * jac).abs().max() + base.abs().max())
        assert resid < 1e-4 * scale + 1e-11
    _, (ap, at, aq) = tcu.cuadjtqs_ad(psp, t, q, jt, jq, tp, kcall=kcall)
    n1 = float((jt * jt).sum() + (jq * jq).sum())
    n2 = float((dp * ap).sum() + (dt_ * at).sum() + (dq * aq).sum())
    assert abs(n1 - n2) / abs(n2) < 1e-12


@pytest.mark.parametrize("kcall", [1, 2])
def test_cuadjtqs_clamp_tie_derivative_matches_jax(params, monkeypatch, kcall):
    """Where the first increment is exactly 0 with a tangent that is not,
    the clamp sits at its tie: the derivative splits evenly there, as
    ``jnp.maximum``/``jnp.minimum`` split it (a ``torch.clamp`` would pass it
    whole).  The first Newton step is made to return ``cond -
    stop_gradient(cond)`` in both packages."""
    import jax

    jp, tp = params
    orig, jorig = tcu._newton_step, jcu._newton_step
    calls, jcalls = [], []

    def zero_first(t, q, *args):
        cond = orig(t, q, *args)
        calls.append(None)
        return cond - cond.detach() if len(calls) % 2 == 1 else cond

    def jzero_first(t, q, *args):
        cond = jorig(t, q, *args)
        jcalls.append(None)
        return cond - jax.lax.stop_gradient(cond) if len(jcalls) % 2 == 1 else cond

    monkeypatch.setattr(tcu, "_newton_step", zero_first)
    monkeypatch.setattr(jcu, "_newton_step", jzero_first)
    x = (np.array([8.5e4, 8.0e4]), np.array([285.0, 265.0]), np.array([0.02, 0.001]))
    d = tuple(0.01 * v for v in x)
    _, jd = jcu.cuadjtqs_tl(*_j(*x, *d), jp, kcall=kcall)
    _, td = tcu.cuadjtqs_tl(*_t(*x, *d), tp, kcall=kcall)
    for a, b in zip(td, jd):
        assert _rel(a.numpy(), b) <= TOL
