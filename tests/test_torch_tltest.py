"""The port's standalone TL and AD paths against the JAX package.

The same numpy inputs (the 100-column fixture, or a seeded synthetic state
with 23 levels where only the plumbing is at stake) go through both
packages.  Tolerances are max |port - jax| / max |jax| per field unless a
test says otherwise:

* 1e-12 (f64) for the truth path ``cloudsc2()`` against JAX's: the same
  statements in the same order over 137 levels, up to the last bits of the
  two packages' libm;
* 1e-11 (f64) for ``tlad.cloudsc2_tl``/``cloudsc2_ad`` against JAX's
  jvp/vjp, and for ``run_tlad`` through the kernels' standard-contract
  wrappers (their plain versions here) against the same;
* the ten Taylor norms within 1e-13·|norm| + 1e-13/λ: the difference
  NL(x+λδx) − NL(x) carries rounding noise of ~ε/λ of the signal, which is
  where the two packages' last bits show.

On the CPU every wrapper runs its kernel's plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudsc2jax import drivers as jdrivers
from cloudsc2jax import tlad as jtlad
from cloudsc2jax.physics.cloudsc2 import cloudsc2 as jcloudsc2
from cloudsc2jax.state import Cloudsc2State as JaxState
from cloudsc2jax_torch import cli, drivers, tlad
from cloudsc2jax_torch.convert import contract_from_numpy, params_from_jax
from cloudsc2jax_torch.kernels import tlad_kernel as tk
from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs, cloudsc2
from cloudsc2jax_torch.state import Cloudsc2State


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _assert_close(got, want, tol, what):
    assert got._fields == want._fields
    for name, a, b in zip(want._fields, got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.shape == np.shape(b), (what, name)
        assert _rel(a, b) < tol, (what, name, _rel(a, b))


def _scaled(tree, scale=jdrivers.DSCALE):
    return type(tree)(*(scale * x for x in tree))


@pytest.fixture(scope="module")
def tparams(state):
    return params_from_jax(state.params)


@pytest.fixture(scope="module")
def tinputs(inputs):
    """The fixture's 100 columns, f64, in the standard contract."""
    return contract_from_numpy(inputs)


@pytest.fixture(scope="module")
def small():
    """A seeded synthetic state, 64 columns x 23 levels, f64: the JAX
    state, its inputs and the port's params and inputs."""
    st = JaxState.synthetic(ngptot=64, nlev=23)
    ji = st.kernel_inputs()
    return st, ji, params_from_jax(st.params), contract_from_numpy(ji)


# ------------------------------------------------------------ the truth path
@pytest.mark.parametrize("lphylin", [True, False])
@pytest.mark.parametrize("ldrain1d", [False, True])
def test_cloudsc2_matches_jax(state, inputs, tparams, tinputs, lphylin, ldrain1d):
    jp = dataclasses.replace(
        state.params, yrephli=dataclasses.replace(state.params.yrephli,
                                                  lphylin=lphylin))
    tp = dataclasses.replace(
        tparams, yrephli=dataclasses.replace(tparams.yrephli, lphylin=lphylin))
    got = cloudsc2(tinputs, tp, ldrain1d=ldrain1d)
    want = jcloudsc2(inputs, jp, ldrain1d=ldrain1d)
    _assert_close(got, want, 1e-12, "cloudsc2")
    if ldrain1d:
        assert float(got.pcovptot.abs().max()) > 0.0


def test_cloudsc2_lregcl_is_identity_on_the_trajectory_and_remat_raises(small):
    _, _, tp, ti = small
    a = cloudsc2(ti, tp, lregcl=False)
    b = cloudsc2(ti, tp, lregcl=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(NotImplementedError, match="remat_level"):
        cloudsc2(ti, tp, remat_level=True)


@pytest.fixture(scope="module")
def truth(state, inputs, tparams, tinputs):
    """Per ``lregcl``: the port's and JAX's TL image of the canonical
    increments and the adjoint seeded with it, f64, computed once."""
    cache = {}

    def get(lregcl):
        if lregcl not in cache:
            _, tdout = tlad.cloudsc2_tl(tinputs, _scaled(tinputs), tparams,
                                        lregcl=lregcl)
            tout, tadj = tlad.cloudsc2_ad(tinputs, tdout, tparams, lregcl=lregcl)
            jdi = jax.tree.map(lambda x: jdrivers.DSCALE * jnp.asarray(x), inputs)
            _, jdout = jtlad.cloudsc2_tl(inputs, jdi, state.params, lregcl=lregcl)
            jout, jadj = jtlad.cloudsc2_ad(inputs, jdout, state.params,
                                           lregcl=lregcl)
            cache[lregcl] = (tout, tdout, tadj), (jout, jdout, jadj)
        return cache[lregcl]

    return get


@pytest.mark.parametrize("lregcl", [False, True])
def test_truth_tl_and_ad_match_jax(truth, lregcl):
    (tout, tdout, tadj), (jout, jdout, jadj) = truth(lregcl)
    _assert_close(tout, jout, 1e-12, "primal")
    _assert_close(tdout, jdout, 1e-11, "tangent")
    _assert_close(tadj, jadj, 1e-11, "adjoint")


def test_lregcl_changes_the_tangent(truth):
    """The damp sites are live on the fixture: the regularised tangent
    differs from the exact one."""
    (_, exact, _), _ = truth(False)
    (_, damped, _), _ = truth(True)
    assert _rel(damped.tenl_q.numpy(), exact.tenl_q.numpy()) > 1e-3


# ------------------------------------------------- Taylor and adjoint tests
def test_taylor_test_matches_jax(state, inputs, tparams, tinputs):
    want = jdrivers.taylor_test(inputs, state.params, nproma=1)
    got = drivers.taylor_test(tinputs, tparams, nproma=1)
    assert (got.istart, got.penalty, got.passed) == (
        want.istart, want.penalty, want.passed)
    assert got.passed and got.penalty <= 5
    for i, (a, b) in enumerate(zip(got.norms, want.norms)):
        lam = 10.0 ** -(i + 1)
        assert abs(a - b) <= 1e-13 * abs(b) + 1e-13 / lam, (i, a, b)


def test_taylor_test_blocks_and_report(small, capsys):
    """NPROMA larger than one, with a ragged last block, against JAX on the
    small state; and the reference's report format."""
    st, ji, tp, ti = small
    want = jdrivers.taylor_test(ji, st.params, nproma=24)
    got = drivers.taylor_test(ti, tp, nproma=24)
    assert (got.istart, got.penalty, got.passed) == (
        want.istart, want.penalty, want.passed)
    for i, (a, b) in enumerate(zip(got.norms, want.norms)):
        assert abs(a - b) <= 1e-13 * abs(b) + 1e-13 * 10.0 ** (i + 1)
    got.report()
    err = capsys.readouterr().err
    assert " TL Taylor test " in err
    assert ("TEST PASSED, penalty" in err) == got.passed


def test_adjoint_test_matches_jax(state, inputs, tparams, tinputs, capsys):
    """The verdict and its size: the error itself is rounding noise (tens
    of epsilons in both packages), so the two are held to the threshold and
    to lying above 1 epsilon and below 1e3."""
    want = jdrivers.adjoint_test(inputs, state.params)
    got = drivers.adjoint_test(tinputs, tparams)
    assert got.passed and want.passed
    assert 1.0 < got.max_error < 1e3 and 1.0 < want.max_error < 1e3
    got.report()
    assert "TEST OK" in capsys.readouterr().err


def test_adjoint_test_fails_on_a_broken_adjoint(small, monkeypatch):
    from cloudsc2jax_torch import ops

    _, _, tp, ti = small
    assert drivers.adjoint_test(ti, tp).passed

    def bad_backward(ctx, g):  # the adjoint damps by another factor
        factor = ctx.factor if ctx.factor is not None else ctx.saved_tensors[0]
        return g * factor * 1.5, None

    monkeypatch.setattr(ops._DampTangent, "backward", staticmethod(bad_backward))
    assert not drivers.adjoint_test(ti, tp).passed


def test_perturbations_and_block_sums_match_jax(small):
    _, ji, _, ti = small
    for zero in (False, True):
        got = drivers._perturbations(ti, zero_supsat=zero)
        want = jdrivers._perturbations(ji, zero_supsat=zero)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = np.random.default_rng(5).normal(size=(64, 23))
    for nproma in (1, 24, 64, 100):
        np.testing.assert_allclose(
            drivers._block_sums(torch.from_numpy(x), nproma).numpy(),
            np.asarray(jdrivers._block_sums(jnp.asarray(x), nproma)),
            rtol=1e-14, atol=1e-14)


# ------------------------------------------------------------ run_tlad, CLI
def test_run_tlad_backends_agree(small):
    """The standard contract through the kernels' plain versions against
    the truth path (1e-11, f64), and the truth path against JAX's
    ``run_tlad(backend="xla")`` (1e-11)."""
    st, ji, tp, ti = small
    kern = drivers.run_tlad(ti, tp, backend="kernels")
    true = drivers.run_tlad(ti, tp, backend="truth")
    want = jdrivers.run_tlad(ji, st.params, backend="xla", lregcl=True)
    for k, t, w in zip(kern, true, want):
        _assert_close(t, w, 1e-11, "truth vs jax")
        _assert_close(k, w, 1e-11, "kernels vs jax")
    rel, finite = cli.adjoint_identity(ti, kern[1], kern[2], tp, drivers.DSCALE)
    assert finite and rel < 1e-10
    with pytest.raises(ValueError, match="write_primal"):
        drivers.run_tlad(ti, tp, backend="kernels", write_primal=False)
    with pytest.raises(ValueError, match="backend"):
        drivers.run_tlad(ti, tp, backend="pallas")


def test_measure_f32_verdicts(small):
    """The f32 verdicts through the kernels' plain versions on the small
    state sit inside the JAX package's budgets, and a TL that drops one
    increment does not."""
    st, _, tp, ti = small
    tst = Cloudsc2State(fields={}, params=tp, ngptot=64, klon_file=64)
    v = cli.measure_f32_verdicts(tst, ti, lregcl=True)
    assert v["finite"]
    assert v["tl_parity_tol"] == cli.PALLAS_TL_PARITY_TOL == 1e-6
    # the plain versions round like the truth path: far inside the JAX
    # package's own 1e-6
    assert v["tl_parity_rel_err"] < 1e-6
    assert v["ad_identity_rel_err"] < v["ad_identity_tol"] == 2e-6
    i32 = Cloudsc2Inputs(*(x.float() for x in ti))
    _, dout = tk.cloudsc2_kernel_tl(i32, _scaled(i32)._replace(
        pq=torch.zeros_like(i32.pq)), tp, lregcl=True)
    assert cli.tl_parity(i32, dout, tp, lregcl=True) > 1e-3


def test_cli_tl_passes_on_cpu(capsys):
    assert cli.main(["tl", "1", "100", "1", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "TL Taylor test" in err and "TEST PASSED, penalty" in err


def test_cli_ad_passes_on_cpu(capsys):
    assert cli.main(["ad", "1", "100", "100", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "AD TEST" in err and "TEST OK" in err


@pytest.mark.parametrize("variant,key", [("tl", "tl_parity_rel_err"),
                                         ("ad", "ad_identity_rel_err")])
def test_cli_kernels_verdict_gates_the_exit_code(monkeypatch, capsys, variant, key):
    """``--kernels`` adds the f32 verdict to the f64 one: a miss of the
    variant's own quantity fails the run, a miss of the other does not.
    The measurement itself is held by ``test_measure_f32_verdicts``; the
    f64 tests are replaced by passing stubs to keep this test short."""
    verdict = {"tl_parity_rel_err": 1e-8, "ad_identity_rel_err": 1e-8,
               "finite": True, "tl_parity_tol": 1e-5, "ad_identity_tol": 2e-6}
    seen = {}

    def fake(state, inputs, *, lregcl):
        seen["lregcl"] = lregcl
        return dict(verdict)

    monkeypatch.setattr(cli, "measure_f32_verdicts", fake)
    monkeypatch.setattr(drivers, "taylor_test", lambda *a, **k: drivers.TaylorResult(
        np.ones(10), 1, 5, True))

    def fake_adjoint_test(inputs, params, *, lregcl, threshold):
        seen["threshold"] = threshold
        return drivers.AdjointResult(64.0, 64.0 < threshold)

    monkeypatch.setattr(drivers, "adjoint_test", fake_adjoint_test)
    argv = [variant, "1", "8", "8", "--device", "cpu", "--kernels"]
    assert cli.main(argv) == 0
    assert seen["lregcl"] == (variant == "ad")
    if variant == "ad":  # --threshold is in working-precision epsilons
        assert seen["threshold"] == 1.0e4
        assert cli.main(argv + ["--threshold", "10"]) == 1
        assert seen["threshold"] == 10.0
        assert "TEST FAILED" in capsys.readouterr().err
        assert cli.main(argv) == 0
    assert f"{variant.upper()}(kernels)" in capsys.readouterr().err
    verdict[key] = 1e-3
    assert cli.main(argv) == 1
    other = "ad_identity_rel_err" if variant == "tl" else "tl_parity_rel_err"
    verdict[key], verdict[other] = 1e-8, 1e-3
    assert cli.main(argv) == 0
    with pytest.raises(SystemExit):
        cli.main(["tlad", "1", "8", "8", "--device", "cpu", "--kernels"])


