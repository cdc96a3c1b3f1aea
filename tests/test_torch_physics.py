"""The port's SATUR, level body and plain NL sweep against the JAX package.

Inputs are made once (fixture or seeded synthetic state, numpy) and fed to
both packages.  Tolerances are max |port - jax| / max |jax| per field:

* 1e-12 at f64 and 5e-6 at f32 for the level body and the sweep: the two
  packages' libm ``exp``/``tanh`` differ in the last bits, and the
  difference is carried through 137 levels (5e-6 is ``test_pallas.py``'s
  bound for the same comparison inside the JAX package);
* 1e-13 for SATUR, the bound of ``test_nl_golden.py``.

The JAX Pallas kernel runs as ``tests/test_pallas.py`` runs it: in
interpret mode at nlev 23, 256 columns, one sublane.
"""

import dataclasses
import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudsc2jax.pallas.cloudsc2_kernel import (
    _level_physics,
    _tropopause_eta_lm,
    cloudsc2_pallas,
)
from cloudsc2jax.physics.cloudsc2 import cloudsc2
from cloudsc2jax.physics.satur import satur as jsatur
from cloudsc2jax.state import Cloudsc2State as JaxState
from cloudsc2jax_torch import io as tio
from cloudsc2jax_torch import validate as tval
from cloudsc2jax_torch.convert import inputs_from_numpy, params_from_jax
from cloudsc2jax_torch.drivers import run_nl
from cloudsc2jax_torch.kernels.cloudsc2_kernel import unblock_outputs
from cloudsc2jax_torch.kernels import cloudsc2_kernel as kmod
from cloudsc2jax_torch.kernels import experiments as ex
from cloudsc2jax_torch.physics.satur import satur

from conftest import FIXTURES

TOL = {np.float64: 1e-12, np.float32: 5e-6}
TORCH_DTYPE = {np.float64: torch.float64, np.float32: torch.float32}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def tparams(state):
    return params_from_jax(state.params)


def _numpy_satur(pap, t, params, lphylin, kflag):
    """SATUR in numpy float64 (libm's exp), the formulas of
    ``cloudsc2jax.physics.satur`` and ``cloudsc2jax.thermo``: a third
    evaluation beside the two packages'."""
    cst, thf = params.yomcst, params.yoethf
    lo, rr = (thf.rticecu, thf.rtwat_rticecu_r) if (not lphylin and kflag == 1) \
        else (thf.rtice, thf.rtwat_rtice_r)
    alfa = np.minimum(1.0, ((np.maximum(lo, np.minimum(thf.rtwat, t)) - lo) * rr) ** 2)
    ew = np.exp(thf.r3les * (t - cst.rtt) / (t - thf.r4les))
    ei = np.exp(thf.r3ies * (t - cst.rtt) / (t - thf.r4ies))
    if lphylin:
        e = alfa * (thf.r2es * ew) + (1.0 - alfa) * (thf.r2es * ei)
    else:
        e = thf.r2es * (alfa * ew + (1.0 - alfa) * ei)
    qs = np.minimum(e / pap, 0.5)
    return qs / (1.0 - cst.retv * qs)


def _satur_sides(state, tparams, lphylin, kflag):
    """(port, JAX package, numpy) SATUR of the fixture state."""
    pap, pt = state.fields["PAP"], state.fields["PT"]
    mine = satur(torch.from_numpy(pap), torch.from_numpy(pt), tparams,
                 lphylin=lphylin, kflag=kflag).numpy()
    ref = np.asarray(jsatur(pap, pt, state.params, lphylin=lphylin, kflag=kflag))
    return mine, ref, _numpy_satur(pap, pt, state.params, lphylin, kflag)


@pytest.mark.parametrize("lphylin,kflag", [(True, 2), (False, 1), (False, 2)])
def test_satur_sides_match_a_numpy_evaluation(state, tparams, lphylin, kflag):
    """Each package's SATUR against a third evaluation at the same bound, so
    that a miss of ``test_satur_matches_jax`` names the side that moved."""
    mine, ref, oracle = _satur_sides(state, tparams, lphylin, kflag)
    assert _rel(mine, oracle) < 1e-13, "the port's SATUR"
    assert _rel(ref, oracle) < 1e-13, "the JAX package's SATUR"


@pytest.mark.parametrize("lphylin,kflag", [(True, 2), (False, 1), (False, 2)])
def test_satur_matches_jax(state, tparams, lphylin, kflag):
    mine, ref, oracle = _satur_sides(state, tparams, lphylin, kflag)
    assert _rel(mine, ref) < 1e-13, (
        f"port - numpy {_rel(mine, oracle):.3e}, jax - numpy {_rel(ref, oracle):.3e}")


def test_satur_matches_golden(state, tparams):
    with np.load(FIXTURES / "reference.npz") as z:
        ref = np.moveaxis(z["PQSAT"], -1, 0)
    mine = satur(torch.from_numpy(state.fields["PAP"]),
                 torch.from_numpy(state.fields["PT"]), tparams).numpy()
    assert _rel(mine, ref) < 1e-13


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kernel_prelude_matches_jax(state, tparams, dtype):
    inputs = state.kernel_inputs(dtype=dtype)
    lm = inputs_from_numpy(inputs, dtype=TORCH_DTYPE[dtype])
    pre = kmod.kernel_prelude(lm, tparams)
    ceta = jnp.asarray(state.params.ceta, dtype)
    zscalm = (0.9 * jnp.maximum(ceta - 0.2, 1e-12) ** 0.2).astype(dtype)
    ztp1 = jnp.asarray(inputs.pt.T) + state.params.ptsphy * jnp.asarray(inputs.ten_t.T)
    np.testing.assert_array_equal(pre.ceta.numpy(), np.asarray(ceta))
    assert _rel(pre.zscalm.numpy(), zscalm) < TOL[dtype]
    np.testing.assert_array_equal(pre.ztrpaus.numpy(),
                                  np.asarray(_tropopause_eta_lm(ztp1, ceta)))
    np.testing.assert_array_equal(pre.paph_sfc.numpy(), inputs.paph[:, -1])


@pytest.mark.parametrize("dtype,ldrain1d", [
    (np.float64, False), (np.float64, True), (np.float32, False)])
def test_level_physics_matches_jax_level_by_level(state, tparams, dtype, ldrain1d):
    """Each level gets identical inputs, including the carry from the JAX
    side, so every level's outputs compare the two level bodies alone."""
    inputs = state.kernel_inputs(dtype=dtype)
    lm = inputs_from_numpy(inputs, dtype=TORCH_DTYPE[dtype])
    pre = kmod.kernel_prelude(lm, tparams)
    jlevel = jax.jit(functools.partial(_level_physics, state.params, ldrain1d))
    nlev = lm.pt.shape[0]
    names = kmod._LEVEL_FIELDS
    jcols = (jnp.asarray(pre.ztrpaus.numpy()), jnp.asarray(pre.paph_sfc.numpy()))
    zero = np.zeros(lm.pt.shape[1], dtype)
    jcarry = (zero, zero, zero)
    mine, theirs = [], []
    for k in range(nlev):
        rows = [getattr(lm, n)[k] for n in names] + [
            lm.plu[min(k + 1, nlev - 1)], lm.paph[k], lm.paph[k + 1]]
        jrows = tuple(jnp.asarray(r.numpy()) for r in rows)
        jscalars = (jnp.asarray(pre.ceta[k].numpy()),
                    jnp.asarray(pre.zscalm[k].numpy()),
                    jnp.asarray(k < nlev - 1))
        jout, jnext = jlevel(jscalars, jrows, jcols, jcarry)
        tout, tnext = kmod.level_physics(
            tparams, ldrain1d, (pre.ceta[k], pre.zscalm[k], k < nlev - 1),
            tuple(rows), (pre.ztrpaus, pre.paph_sfc),
            tuple(torch.from_numpy(np.array(c)) for c in jcarry))
        theirs.append(np.stack([np.asarray(x) for x in (*jout, *jnext)]))
        mine.append(np.stack([x.numpy() for x in (*tout, *tnext)]))
        jcarry = tuple(np.asarray(c) for c in jnext)
    mine, theirs = np.stack(mine, 1), np.stack(theirs, 1)
    for i in range(mine.shape[0]):
        assert mine[i].dtype == dtype
        assert _rel(mine[i], theirs[i]) < TOL[dtype], i


def test_reference_sweep_matches_pallas_interpret():
    """The plain sweep against the JAX Pallas kernel itself
    (blocked, fuse_satur, interpret) at test_pallas.py's small shape."""
    st = JaxState.synthetic(ngptot=100, nlev=23)
    blk = st.device_kernel_inputs(256, dtype=np.float32, blocked_sublanes=1)
    ref = cloudsc2_pallas(blk, st.params, blocked=True, fuse_satur=True,
                          interpret=True)
    lm = type(blk)(*(
        torch.from_numpy(np.asarray(x).reshape(x.shape[0], -1).copy())
        for x in blk))
    out = kmod.cloudsc2_nl_reference(lm, params_from_jax(st.params))
    for name, a, b in zip(out._fields, out, ref):
        b = np.asarray(b).reshape(b.shape[0], -1)
        assert a.shape == b.shape
        assert _rel(a.numpy(), b) < 5e-6, name


def test_run_nl_matches_jax_cloudsc2_fixture_f64(state, inputs, nl_outputs, tparams):
    out = unblock_outputs(run_nl(inputs_from_numpy(inputs), tparams), tparams)
    for name, a, b in zip(out._fields, out, nl_outputs):
        assert tuple(a.shape) == np.shape(b), name
        assert _rel(a.numpy(), b) < 1e-12, name


@pytest.mark.parametrize("seed,nlev,ncol,ldrain1d", [
    (7, 11, 97, False),
    (11, 21, 259, True),
])
def test_run_nl_matches_jax_cloudsc2_random_f32(seed, nlev, ncol, ldrain1d):
    st = JaxState.synthetic(ngptot=ncol, nlev=nlev, seed=seed)
    inputs = st.kernel_inputs(dtype=np.float32)
    ref = cloudsc2(inputs, st.params, ldrain1d=ldrain1d)
    params = params_from_jax(st.params)
    out = unblock_outputs(run_nl(inputs_from_numpy(inputs, dtype=torch.float32),
                                 params, ldrain1d=ldrain1d), params)
    for name, a, b in zip(out._fields, out, ref):
        assert a.dtype == torch.float32
        assert tuple(a.shape) == np.shape(b), name
        assert _rel(a.numpy(), b) < 5e-6, (seed, name)


@pytest.mark.parametrize("ldrain1d,golden", [
    (False, "reference.npz"), (True, "reference_ldrain1d.npz")])
def test_port_f64_passes_golden(state, inputs, tparams, ldrain1d, golden):
    """The reference's own validation at 10 x eps64 on the fixture."""
    out = unblock_outputs(run_nl(inputs_from_numpy(inputs), tparams,
                                 ldrain1d=ldrain1d), tparams)
    from cloudsc2jax_torch.state import Cloudsc2State

    st = Cloudsc2State.load(FIXTURES / "input.npz")
    ref = tio.load_reference_h5(FIXTURES / golden)
    errors = tval.validate(st.output_dict(out), ref)
    assert len(errors) == 10
    for e in errors.values():
        assert e.passed(10.0), (e.name, e.relerr)


@pytest.mark.parametrize("ldrain1d", [False, True])
def test_sweep_computes_its_own_pqs(state, tparams, ldrain1d):
    """The sweep reads no pqs: SATUR of pt and pap is computed level by
    level, so a given pqs, a wrong one and none give identical outputs."""
    inputs = inputs_from_numpy(state.kernel_inputs())
    given = kmod.cloudsc2_nl(inputs, tparams, ldrain1d=ldrain1d)
    for pqs in (None, 2.0 * inputs.pqs):
        other = kmod.cloudsc2_nl(inputs._replace(pqs=pqs), tparams,
                                 ldrain1d=ldrain1d)
        for name, a, b in zip(given._fields, given, other):
            assert torch.equal(a, b), name


def test_wrapper_dispatch(state, tparams):
    """CPU tensors run the plain version; other devices raise; a
    non-LPHYLIN configuration is refused."""
    inputs = inputs_from_numpy(state.kernel_inputs())
    launches = kmod.cloudsc2_nl.launches
    out = kmod.cloudsc2_nl(inputs, tparams)
    ref = kmod.cloudsc2_nl_reference(inputs, tparams)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert kmod.cloudsc2_nl.launches == launches
    meta = type(inputs)(*(x.to("meta") for x in inputs))
    with pytest.raises(ValueError):
        kmod.cloudsc2_nl(meta, tparams)
    with pytest.raises(ValueError):
        kmod.launch_cloudsc2_nl(inputs, kmod.kernel_prelude(inputs, tparams),
                                tparams)
    no_phylin = dataclasses.replace(
        tparams, yrephli=dataclasses.replace(tparams.yrephli, lphylin=False))
    with pytest.raises(NotImplementedError):
        kmod.cloudsc2_nl(inputs, no_phylin)


def _enum(source, name, prefix=True):
    body = re.search(r"enum " + name + r" \{(.*?)\};", source, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = [t.split("=")[0].strip() for t in body.replace("\n", " ").split(",")
             if t.strip()]
    names = [n for n in names if n != "N" and not n.startswith("N_")]
    return [(n.split("_", 1)[1] if prefix else n).lower() for n in names]


def test_kernel_argument_order_matches_cuda_source():
    """The wrapper fills the launcher's three argument arrays by position:
    its name lists must follow the enums of the CUDA source (the sweep
    header the NL kernels share: `Order` lists the streams with pqs in its
    place, and the order without pqs is that list less pqs)."""
    src = (pathlib.Path(kmod.__file__).parents[1] / "csrc"
           / "cloudsc2_nl_sweep.cuh").read_text()
    order = _enum(src, ": int", prefix=False)
    assert order == list(ex.RESIDENT_STREAMS)
    assert [n for n in order if n != "pqs"] == list(kmod.KERNEL_STREAMS)
    assert kmod.FWD_CKPT_STREAMS == kmod.KERNEL_STREAMS + ("pqs",)
    assert _enum(src, "Output") == list(kmod.KERNEL_OUTPUTS)
    assert _enum(src, "Const") == list(kmod.KERNEL_CONSTANTS)
    assert _enum(src, "Value") == list(kmod._LEVEL_FIELDS) + [
        "plu_k1", "paph_lo", "paph_hi"]
    consts = kmod._kernel_constants(params_from_jax(
        JaxState.synthetic(ngptot=4, nlev=5).params), ldrain1d=True)
    assert len(consts) == len(kmod.KERNEL_CONSTANTS)
    assert all(np.isfinite(consts))
