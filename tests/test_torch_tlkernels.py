"""The kernels of the port's standalone TL and AD paths against the JAX
package: the standard-contract wrappers, the streamed-increment TL sweep
and the checkpointing forward sweep.  On the CPU every wrapper runs its
kernel's plain version.

Tolerances are max |port - jax| / max |jax| per field:

* f32 against the Pallas kernels in interpret mode, run as
  ``tests/test_pallas_tlad.py:39-68`` runs them (``sublanes=1``): 5e-6 for
  the primal outputs, 5e-5 for the tangents and 1e-4 for the adjoints, the
  JAX package's own bounds for its kernels against jvp/vjp;
* 1e-11 (f64) against JAX's jvp/vjp;
* 1e-12 (f64) between the forward-checkpoint sweep and the TL sweep's own
  checkpoints and primal streams, the same level body on the same inputs.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudsc2jax import drivers as jdrivers
from cloudsc2jax import tlad as jtlad
from cloudsc2jax.pallas import tlad_kernel as jtk
from cloudsc2jax.pallas.cloudsc2_kernel import _Layout
from cloudsc2jax.physics.cloudsc2 import Cloudsc2Outputs as JOutputs
from cloudsc2jax.state import Cloudsc2State as JaxState
from cloudsc2jax_torch.convert import contract_from_numpy, params_from_jax
from cloudsc2jax_torch.kernels import cloudsc2_kernel as kmod
from cloudsc2jax_torch.kernels import tlad_kernel as tk
from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs, Cloudsc2Outputs
from cloudsc2jax_torch.state import Cloudsc2State

from conftest import FIXTURES


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


# ------------------------------------ the kernels' standard-contract wrappers
def test_seed_streams_matches_jax(small):
    st, ji, tp, _ = small
    rng = np.random.default_rng(7)
    ncol, nlev = np.shape(ji.pt)
    d = JOutputs(*(rng.normal(size=(ncol, nlev + (f.startswith("pf"))))
                   for f in JOutputs._fields))
    lay = _Layout(ji, st.params, 1, False)
    want = jtk._seed_streams(lay, st.params, d, False)
    got = tk.seed_streams(contract_from_numpy(d, Cloudsc2Outputs), tp)
    got_lm = tk.seed_streams(
        Cloudsc2Outputs(*(torch.from_numpy(np.ascontiguousarray(x.T)) for x in d)),
        tp, levels_major=True)
    for a, a_lm, b in zip(got, got_lm, want):
        b = np.asarray(b).reshape(nlev, -1)[:, :ncol]
        assert a.is_contiguous() and tuple(a.shape) == (nlev, ncol)
        assert _rel(a.numpy(), b) < 1e-15
        assert torch.equal(a, a_lm)


@pytest.fixture(scope="module")
def f32_case(state, tparams):
    """The fixture in f32 with the canonical increments, for both packages,
    and JAX's f32 TL image per ``lregcl`` (the AD's seed, as
    ``test_pallas_tlad.py:53-58`` seeds it)."""
    ji = state.kernel_inputs(dtype=np.float32)
    jdi = jax.tree.map(lambda x: 0.01 * jnp.asarray(x), ji)
    ti = contract_from_numpy(ji, dtype=torch.float32)
    tdi = contract_from_numpy(jdi, dtype=torch.float32)
    seeds = {lregcl: jtlad.cloudsc2_tl(ji, jdi, state.params, lregcl=lregcl)[1]
             for lregcl in (False, True)}
    return ji, jdi, ti, tdi, seeds


@pytest.mark.parametrize("lregcl", [False, True])
def test_kernel_tl_matches_pallas_interpret(state, tparams, f32_case, lregcl):
    ji, jdi, ti, tdi, _ = f32_case
    jout, jdout = jtk.cloudsc2_pallas_tl(ji, jdi, state.params, lregcl=lregcl,
                                         sublanes=1, interpret=True)
    launches = tk.cloudsc2_tl_din.launches
    out, dout = tk.cloudsc2_kernel_tl(ti, tdi, tparams, lregcl=lregcl)
    assert tk.cloudsc2_tl_din.launches == launches  # the plain version ran
    assert out.tenl_t.dtype == dout.pfhpsl.dtype == torch.float32
    _assert_close(out, jout, 5e-6, "primal")
    _assert_close(dout, jdout, 5e-5, "tangent")


@pytest.mark.parametrize("lregcl", [False, True])
def test_kernel_ad_matches_pallas_interpret(state, tparams, f32_case, lregcl):
    ji, _, ti, _, seeds = f32_case
    jout, jadj = jtk.cloudsc2_pallas_ad(ji, seeds[lregcl], state.params,
                                        lregcl=lregcl, sublanes=1, interpret=True)
    tseed = contract_from_numpy(seeds[lregcl], Cloudsc2Outputs, dtype=torch.float32)
    out, adj = tk.cloudsc2_kernel_ad(ti, tseed, tparams, lregcl=lregcl)
    _assert_close(out, jout, 5e-6, "primal")
    _assert_close(adj, jadj, 1e-4, "adjoint")


def test_kernel_wrappers_f64_match_jax_autodiff(state, inputs, tparams, tinputs):
    """f64 at 1e-11 against JAX's jvp/vjp (which its Pallas kernels match
    to rounding in interpret mode), at the settings the CLI's verdicts use:
    the exact TL and the regularised AD.  (``test_torch_tltest.py`` holds
    the levels-major option through ``run_tlad``.)"""
    jdi = jax.tree.map(lambda x: jdrivers.DSCALE * jnp.asarray(x), inputs)
    jout, jdout_exact = jtlad.cloudsc2_tl(inputs, jdi, state.params, lregcl=False)
    _, jdout_reg = jtlad.cloudsc2_tl(inputs, jdi, state.params, lregcl=True)
    _, jadj = jtlad.cloudsc2_ad(inputs, jdout_reg, state.params, lregcl=True)
    out, dout = tk.cloudsc2_kernel_tl(tinputs, _scaled(tinputs), tparams,
                                      lregcl=False)
    _assert_close(out, jout, 1e-12, "primal")
    _assert_close(dout, jdout_exact, 1e-11, "tangent")
    seed = contract_from_numpy(jdout_reg, Cloudsc2Outputs)
    out, adj = tk.cloudsc2_kernel_ad(tinputs, seed, tparams, lregcl=True)
    _assert_close(out, jout, 1e-12, "primal")
    _assert_close(adj, jadj, 1e-11, "adjoint")


def test_to_levels_major_copies_only_what_it_must(tparams):
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    std = st.device_inputs(8, dtype=torch.float32, device="cpu")
    assert tuple(std.pt.shape) == (8, 137) and tuple(std.paph.shape) == (8, 138)
    lm = tk.to_levels_major(std)
    assert all(a.data_ptr() == b.data_ptr() and a.is_contiguous()
               for a, b in zip(lm, std))
    copied = tk.to_levels_major(Cloudsc2Inputs(*(x.contiguous() for x in std)))
    assert all(a.is_contiguous() and torch.equal(a, b) for a, b in zip(copied, lm))


def test_device_inputs_match_jax(state):
    """The standard-contract inputs with pqs, against the JAX package's
    non-blocked ``device_kernel_inputs``: equal but for pqs, which is SATUR
    computed by each package (within 4 eps)."""
    tst = Cloudsc2State.load(FIXTURES / "input.npz")
    got = tst.device_inputs(250, dtype=torch.float64, device="cpu")
    want = state.device_kernel_inputs(250, dtype=np.float64)
    for name, a, b in zip(got._fields, got, want):
        if name == "pqs":
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=4 * np.finfo(np.float64).eps, atol=0)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -------------------------------------------- the streamed-increment TL sweep
def test_tl_reference_d_inputs_mode(small):
    """``d_inputs = dscale·x`` gives the tangents of the ``dscale`` mode bit
    for bit (the same products enter the same jvp), other increments give
    other tangents, and exactly one of the two must be given."""
    _, _, tp, ti = small
    lm = tk.to_levels_major(ti)
    a = tk.cloudsc2_tl_reference(lm, tp, dscale=0.01, lregcl=False)
    b = tk.cloudsc2_tl_reference(lm, tp, d_inputs=_scaled(lm, 0.01), lregcl=False)
    for x, y in zip((*a[0], *a[1], *a[2]), (*b[0], *b[1], *b[2])):
        assert torch.equal(x, y)
    d = _scaled(lm, 0.01)._replace(paph=torch.zeros_like(lm.paph))
    c = tk.cloudsc2_tl_reference(lm, tp, d_inputs=d, lregcl=False)
    assert not torch.equal(c[1].tenl_t, a[1].tenl_t)
    out, dout = tk.cloudsc2_tl_din(lm, d, tp)
    assert torch.equal(dout.tenl_t, c[1].tenl_t) and torch.equal(out.pclc, c[0].pclc)
    for kw in ({}, dict(dscale=0.01, d_inputs=d)):
        with pytest.raises(ValueError, match="exactly one"):
            tk.cloudsc2_tl_reference(lm, tp, **kw)


# ---------------------------------------------- the checkpointing forward sweep
def test_fwd_ckpt_matches_the_tl_sweep_with_perturbed_pqs(tparams):
    """pqs is a differentiated input: the forward sweep must follow the
    caller's pqs, not SATUR of (pap, pt).  With pqs perturbed by up to 2%
    it still agrees with the TL sweep's primal streams and checkpoints
    (which read pqs), and no longer with the fused-SATUR NL sweep."""
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    base = st.device_kernel_inputs(100, dtype=torch.float64, device="cpu", pqs=True)
    rng = np.random.default_rng(13)
    bump = torch.from_numpy(1.0 + 0.02 * rng.uniform(-1, 1, size=base.pqs.shape))
    for inputs, fused_agrees in ((base, True), (base._replace(pqs=base.pqs * bump),
                                                False)):
        out, ckpts = kmod.cloudsc2_fwd_ckpt(inputs, tparams)
        if not fused_agrees:
            t_out, _, t_ckpts = tk.cloudsc2_tl_reference(inputs, tparams,
                                                         dscale=0.01)
            for a, b in zip((*out, *ckpts), (*t_out, *t_ckpts)):
                assert _rel(a.numpy(), b.numpy()) < 1e-12
        assert torch.equal(ckpts[0][0], torch.zeros_like(ckpts[0][0]))
        assert torch.equal(ckpts[0][1:], out.rfln[:-1])
        assert torch.equal(ckpts[1][1:], out.sfln[:-1])
        fused = kmod.cloudsc2_nl_reference(inputs, tparams)
        worst = max(_rel(a.numpy(), b.numpy()) for a, b in zip(out, fused))
        assert (worst < 1e-12) == fused_agrees, worst
    with pytest.raises(ValueError, match="pqs"):
        kmod.cloudsc2_fwd_ckpt(base._replace(pqs=None), tparams)


# ------------------------------------------------------------- device rules
def test_new_wrappers_take_cpu_or_cuda_only(tparams):
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    cpu = st.device_kernel_inputs(4, dtype=torch.float32, device="cpu", pqs=True)
    meta = type(cpu)(*(x.to("meta") for x in cpu))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.cloudsc2_tl_din(meta, meta, tparams)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kmod.cloudsc2_fwd_ckpt(meta, tparams)
    pre = kmod.kernel_prelude(cpu, tparams)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.launch_cloudsc2_tl_din(cpu, cpu, pre, tparams)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kmod.launch_cloudsc2_fwd_ckpt(cpu, pre, tparams)
