"""The port's TL+AD work unit against the JAX package.

Inputs come from the fixtures or from numpy with a seed and are fed to
both packages.  Tolerances are max |port - jax| / max |jax| per field:

* 1e-13 (f64) for one level's jvp/vjp: the same statements in the same
  order, up to the last bits of the two packages' libm;
* 1e-12 (f64) for the whole unit over 137 levels against JAX's
  ``run_tlad(backend="xla")``, the bound of ``test_torch_slice.py`` for the
  NL sweep;
* f32 against the Pallas kernels in interpret mode, run as
  ``tests/test_pallas_tlad.py:178-215`` runs them (synthetic nlev 23, 256
  columns, one sublane): 1e-5 for the TL streams; 1e-4 for the adjoints,
  the JAX package's own bound for its Pallas AD against ``jax.vjp``
  (``test_pallas_tlad.py:68``), since the plu adjoint carries f32 rounding
  of ~3e-5 of its maximum;
* the f64 adjoint identity within 1e-10, the CLI's budget.

On the CPU the wrappers run the kernels' plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudsc2jax import ops as jops
from cloudsc2jax.drivers import DSCALE as JDSCALE
from cloudsc2jax.drivers import run_tlad as jrun_tlad
from cloudsc2jax.pallas.cloudsc2_kernel import _level_physics
from cloudsc2jax.pallas.tlad_kernel import cloudsc2_pallas_ad, cloudsc2_pallas_tl
from cloudsc2jax.state import Cloudsc2State as JaxState
from cloudsc2jax_torch import cli, ops
from cloudsc2jax_torch.convert import inputs_from_numpy, params_from_jax
from cloudsc2jax_torch.drivers import DSCALE, run_tlad
from cloudsc2jax_torch.kernels import tlad_kernel as tk
from cloudsc2jax_torch.kernels.cloudsc2_kernel import (
    Cloudsc2StreamOutputs,
    _LEVEL_FIELDS,
    level_physics,
)
from cloudsc2jax_torch.physics.satur import satur
from cloudsc2jax_torch.state import Cloudsc2State

from conftest import FIXTURES

STREAMS = Cloudsc2StreamOutputs._fields


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def tparams(state):
    return params_from_jax(state.params)


# ---------------------------------------------------------------- (a) ops
@pytest.mark.parametrize("tensor_factor", [False, True])
def test_damp_tangent_matches_jax(tensor_factor):
    rng = np.random.default_rng(11)
    x, dx, g = (rng.normal(size=64) for _ in range(3))
    factor = rng.uniform(0.1, 0.9, size=64) if tensor_factor else 0.7
    tf = torch.from_numpy(factor) if tensor_factor else factor
    jf = jnp.asarray(factor) if tensor_factor else factor

    y, dy = torch.func.jvp(lambda v: ops.damp_tangent(v, tf),
                           (torch.from_numpy(x),), (torch.from_numpy(dx),))
    jy, jdy = jax.jvp(lambda v: jops.damp_tangent(v, jf), (jnp.asarray(x),),
                      (jnp.asarray(dx),))
    np.testing.assert_array_equal(y.numpy(), x)
    np.testing.assert_array_equal(dy.numpy(), np.asarray(jdy))
    np.testing.assert_array_equal(np.asarray(jy), x)

    _, vjp_fn = torch.func.vjp(lambda v: ops.damp_tangent(v, tf), torch.from_numpy(x))
    _, jvjp_fn = jax.vjp(lambda v: jops.damp_tangent(v, jf), jnp.asarray(x))
    np.testing.assert_array_equal(vjp_fn(torch.from_numpy(g))[0].numpy(),
                                  np.asarray(jvjp_fn(jnp.asarray(g))[0]))


def test_damp_tangent_is_a_new_tensor_and_factor_gets_no_gradient():
    x = torch.rand(8, dtype=torch.float64)
    f = torch.rand(8, dtype=torch.float64)
    y = ops.damp_tangent(x, f)
    assert y is not x and y.data_ptr() != x.data_ptr()
    _, vjp_fn = torch.func.vjp(ops.damp_tangent, x, f)
    gx, gf = vjp_fn(torch.ones(8, dtype=torch.float64))
    assert torch.equal(gx, f) and torch.equal(gf, torch.zeros_like(f))
    _, df = torch.func.jvp(lambda v: ops.damp_tangent(x, v), (f,), (torch.ones_like(f),))
    assert torch.equal(df, torch.zeros_like(f))


# ---------------------------------------------------- (b) one level's jvp/vjp
def _level_case(state, k: int):
    """One level of the 100 fixture columns plus a constructed tie column
    (pt + ptsphy*ten_t == rtt + 2 exactly, so the snow-melt max(0, .) sits
    on its tie), with seeded carries, tangents and cotangents (numpy f64)."""
    inp = state.kernel_inputs()
    nlev = inp.pt.shape[1]
    f = {n: np.array(getattr(inp, n)[:, k]) for n in _LEVEL_FIELDS}
    f["pt"][0] = state.params.yomcst.rtt + 2.0
    f["ten_t"][0] = 0.0
    fields = [f[n] for n in _LEVEL_FIELDS] + [
        np.asarray(inp.plu[:, min(k + 1, nlev - 1)]), np.asarray(inp.paph[:, k]),
        np.asarray(inp.paph[:, k + 1])]
    ncol = fields[0].shape[0]
    rng = np.random.default_rng(k)
    cols = [rng.uniform(0.15, 0.35, ncol), np.asarray(inp.paph[:, nlev])]
    carry = [rng.uniform(0.0, 2e-4, ncol), rng.uniform(1e-5, 2e-4, ncol),
             rng.uniform(0.0, 1.0, ncol)]
    ceta = state.params.ceta[k]
    scalars = (ceta, 0.9 * max(ceta - 0.2, 1e-12) ** 0.2, k < nlev - 1)
    tangents = ([rng.normal(size=ncol) * np.abs(x) * 1e-2 for x in fields],
                [np.zeros(ncol), rng.normal(size=ncol) * 1e2],
                [rng.normal(size=ncol) * 1e-6 for _ in carry])
    cot = ([rng.normal(size=ncol) for _ in range(8)],
           [rng.normal(size=ncol) for _ in range(3)])
    return scalars, (fields, cols, carry), tangents, cot


@pytest.mark.parametrize("k", [60, 136])
@pytest.mark.parametrize("lregcl", [False, True])
@pytest.mark.parametrize("ldrain1d", [False, True])
def test_level_jvp_vjp_match_jax(state, tparams, k, lregcl, ldrain1d):
    """torch.func.jvp/vjp of ``level_physics`` against jax.jvp/jax.vjp of
    ``_level_physics``, f64, with a row on the max tie of the snow melt:
    jnp.maximum's derivative splits a tie evenly, so the port's must."""
    scalars, primals, tangents, cot = _level_case(state, k)
    assert primals[0][0][0] + state.params.ptsphy * primals[0][9][0] \
        == state.params.yomcst.rtt + 2.0
    ceta, zscalm, not_last = scalars

    def jf(fl, co, ca):
        return _level_physics(state.params, ldrain1d, (ceta, zscalm, not_last),
                              fl, co, ca, lregcl=lregcl)

    def tf(fl, co, ca):
        sc = (torch.tensor(ceta, dtype=torch.float64),
              torch.tensor(zscalm, dtype=torch.float64), not_last)
        return level_physics(tparams, ldrain1d, sc, fl, co, ca, lregcl=lregcl)

    jp = jax.tree.map(jnp.asarray, tuple(tuple(x) for x in primals))
    tp = jax.tree.map(torch.from_numpy, tuple(tuple(x) for x in primals))
    jt = jax.tree.map(jnp.asarray, tuple(tuple(x) for x in tangents))
    tt = jax.tree.map(torch.from_numpy, tuple(tuple(x) for x in tangents))
    (jout, jdout) = jax.jvp(jf, jp, jt)
    (tout, tdout) = torch.func.jvp(tf, tp, tt)
    for a, b in zip(jax.tree.leaves((tout, tdout)), jax.tree.leaves((jout, jdout))):
        assert _rel(a.numpy(), b) < 1e-13

    jc = jax.tree.map(jnp.asarray, tuple(tuple(x) for x in cot))
    tc = jax.tree.map(torch.from_numpy, tuple(tuple(x) for x in cot))
    _, jvjp = jax.vjp(jf, *jp)
    _, tvjp = torch.func.vjp(tf, *tp)
    jg = jvjp(jc)
    tg = tvjp(tc)
    # the tropopause eta's cotangent is dropped by the kernels; compare the rest
    for a, b in zip(jax.tree.leaves((tg[0], tg[1][1], tg[2])),
                    jax.tree.leaves((jg[0], jg[1][1], jg[2]))):
        assert _rel(a.numpy(), b) < 1e-13


def test_not_last_may_be_a_tensor(tparams, state):
    scalars, (fields, cols, carry), _, _ = _level_case(state, 60)
    ceta, zscalm, _ = scalars
    args = [tuple(torch.from_numpy(x) for x in g) for g in (fields, cols, carry)]
    sc = (torch.tensor(ceta, dtype=torch.float64), torch.tensor(zscalm, dtype=torch.float64))
    for flag in (False, True):
        a = level_physics(tparams, False, sc + (flag,), *args)
        b = level_physics(tparams, False, sc + (torch.tensor(flag),), *args)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            assert torch.equal(x, y)


# ------------------------------------------------- repair: the pqs stream
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_device_kernel_inputs_pqs(state, dtype):
    """``pqs=True`` tiles SATUR of the stored columns in the working dtype,
    as the JAX package builds its pqs; the NL default still ships none."""
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    tst = Cloudsc2State.load(FIXTURES / "input.npz")
    mine = tst.device_kernel_inputs(300, dtype=tdtype, device="cpu", pqs=True)
    base = tst.device_kernel_inputs(300, dtype=tdtype, device="cpu")
    assert base.pqs is None
    assert mine.pqs.dtype == tdtype and tuple(mine.pqs.shape) == (137, 300)
    assert torch.equal(mine.pqs[:, :100],
                       satur(mine.pap[:, :100], mine.pt[:, :100], tst.params))
    assert torch.equal(mine.pqs[:, 100:200], mine.pqs[:, :100])
    for a, b in zip(mine, base):
        if b is not None:
            assert torch.equal(a, b)
    theirs = np.asarray(state.device_kernel_inputs(300, dtype=dtype).pqs).T
    np.testing.assert_allclose(mine.pqs.numpy(), theirs,
                               rtol=4 * np.finfo(dtype).eps, atol=0)


# ------------------------------------------------ (c), (e) the whole unit
@pytest.fixture(scope="module")
def unit_f64(tparams):
    """The port's run_tlad at the 100-column fixture, f64, on the CPU."""
    tst = Cloudsc2State.load(FIXTURES / "input.npz")
    inputs = tst.device_kernel_inputs(100, dtype=torch.float64, device="cpu",
                                      pqs=True)
    return inputs, run_tlad(inputs, tparams)


def test_run_tlad_matches_jax_xla(state, unit_f64):
    _, (out, dout, adj) = unit_f64
    jout, jdout, jadj = jrun_tlad(state.kernel_inputs(), state.params,
                                  backend="xla", lregcl=True)
    want = {n: np.asarray(getattr(jdout, n)) for n in STREAMS[:6]}
    want["rfln"] = np.asarray(jdout.pfplsl)[:, 1:]
    want["sfln"] = np.asarray(jdout.pfplsn)[:, 1:]
    for n in STREAMS:
        assert _rel(getattr(dout, n).numpy().T, want[n]) < 1e-12, n
    assert _rel(out.tenl_t.numpy().T, np.asarray(jout.tenl_t)) < 1e-12
    for n in adj._fields:
        a, b = getattr(adj, n).numpy().T, np.asarray(getattr(jadj, n))
        assert a.shape == b.shape and _rel(a, b) < 1e-12, n
    assert JDSCALE == DSCALE


def test_adjoint_identity_f64(tparams, unit_f64):
    inputs, (_, dout, adj) = unit_f64
    rel, finite = cli.adjoint_identity(inputs, dout, adj, tparams, DSCALE)
    assert finite and rel < 1e-10


def test_write_primal_false_gives_the_same_unit():
    st = Cloudsc2State.synthetic(ngptot=8, nlev=23)
    inputs = st.device_kernel_inputs(8, dtype=torch.float32, device="cpu", pqs=True)
    out, dout, adj = run_tlad(inputs, st.params)
    none, dout_n, adj_n = run_tlad(inputs, st.params, write_primal=False)
    assert out is not None and none is None
    for a, b in zip((*dout, *adj), (*dout_n, *adj_n)):
        assert torch.equal(a, b)


# --------------------------------- (d) against the Pallas kernels, f32
@pytest.fixture(scope="module")
def pallas_unit():
    """Synthetic nlev=23, 256 columns, f32, one sublane: the JAX blocked
    inputs, the Pallas TL (both write_primal settings) and AD, interpret
    mode; and the same inputs for the port, levels-major."""
    st = JaxState.synthetic(ngptot=100, nlev=23)
    blk = st.device_kernel_inputs(256, dtype=np.float32, blocked_sublanes=1)
    kw = dict(lregcl=True, blocked=True, save_checkpoints=True, dscale=JDSCALE,
              interpret=True)
    tl = {wp: cloudsc2_pallas_tl(blk, None, st.params, write_primal=wp, **kw)
          for wp in (True, False)}
    _, dout, ck = tl[True]
    _, adj = cloudsc2_pallas_ad(blk, dout, st.params, lregcl=True, blocked=True,
                                checkpoints=ck, fold_seeds=True, interpret=True)

    def lm(x):
        x = np.asarray(x)
        return x.reshape(x.shape[0], -1)

    tin = inputs_from_numpy(type(blk)(*(lm(x).T for x in blk)), dtype=torch.float32)
    return st, tin, tl, adj, lm


@pytest.mark.parametrize("write_primal", [True, False])
def test_plain_tl_matches_pallas_interpret(pallas_unit, write_primal):
    st, tin, tl, _, lm = pallas_unit
    jout, jdout, jck = tl[write_primal]
    out, dout, ck = tk.cloudsc2_tl(tin, params_from_jax(st.params), dscale=DSCALE,
                                   write_primal=write_primal)
    assert (out is None) == (jout is None) == (not write_primal)
    pairs = list(zip(dout, jdout)) + list(zip(ck, jck))
    if write_primal:
        pairs += list(zip(out, jout))
    for a, b in pairs:
        assert _rel(a.numpy(), lm(b)) < 1e-5


def test_plain_ad_matches_pallas_interpret(pallas_unit):
    """The plain AD fed with the Pallas TL's own tangents and checkpoints,
    so it is compared with the Pallas AD on identical seeds."""
    st, tin, tl, jadj, lm = pallas_unit
    _, jdout, jck = tl[True]
    seeds = Cloudsc2StreamOutputs(*(torch.from_numpy(lm(x)) for x in jdout))
    ckpts = tuple(torch.from_numpy(lm(x)) for x in jck)
    adj = tk.cloudsc2_ad(tin, seeds, ckpts, params_from_jax(st.params))
    for n in adj._fields:
        assert _rel(getattr(adj, n).numpy(), lm(getattr(jadj, n))) < 1e-4, n


# --------------------------------------------------------------- (f) CLI
def test_cli_tlad_passes_and_catches_a_broken_adjoint_damp(monkeypatch, capsys):
    argv = ["tlad", "1", "100", "100", "--device", "cpu", "--dtype", "f64",
            "--kernels"]
    assert cli.main(argv) == 0
    assert "adjoint identity rel err" in capsys.readouterr().err

    def bad_backward(ctx, g):  # the adjoint damps by another factor
        factor = ctx.factor if ctx.factor is not None else ctx.saved_tensors[0]
        return g * factor * 1.5, None

    monkeypatch.setattr(ops._DampTangent, "backward", staticmethod(bad_backward))
    assert cli.main(argv) == 1


# -------------------------------------------------------- device rules
def test_wrappers_take_cpu_or_cuda_only(tparams):
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    cpu = st.device_kernel_inputs(4, dtype=torch.float32, device="cpu", pqs=True)
    meta = type(cpu)(*(x.to("meta") for x in cpu))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.cloudsc2_tl(meta, tparams, dscale=DSCALE)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.cloudsc2_ad(meta, Cloudsc2StreamOutputs(*cpu[:8]), cpu[:3], tparams)
    pre = tk.kernel_prelude(cpu, tparams)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.launch_cloudsc2_tl(cpu, pre, tparams, dscale=DSCALE)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.launch_cloudsc2_ad(cpu, pre, Cloudsc2StreamOutputs(*cpu[:8]), cpu[:3],
                              tparams)
    with pytest.raises(ValueError, match="pqs"):
        tk.cloudsc2_tl(cpu._replace(pqs=None), tparams, dscale=DSCALE)


def test_fold_flux_seeds_matches_jax(state, tparams):
    from cloudsc2jax.pallas.cloudsc2_kernel import Cloudsc2BlockedOutputs
    from cloudsc2jax.pallas.tlad_kernel import fold_flux_seeds as jfold

    rng = np.random.default_rng(3)
    d = [rng.normal(size=(5, 7)) for _ in STREAMS]
    mine = tk.fold_flux_seeds(Cloudsc2StreamOutputs(*map(torch.from_numpy, d)), tparams)
    theirs = jfold(Cloudsc2BlockedOutputs(*map(jnp.asarray, d)), state.params)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert dataclasses.asdict(tparams.yomcst)["rlvtt"] == state.params.yomcst.rlvtt
