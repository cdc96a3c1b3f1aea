"""The tropopause eta's band hull and plain prelude on the CPU (the kernel
that walks the hull runs on the card, ``test_torch_cuda.py``).

``tropopause_hull`` is the range of levels the kernel
``csrc/cloudsc2_prelude.cu`` reads.  Over every eta profile of
``prelude_cases.CETA``, in both dtypes: the hull holds every level whose eta
lies in the band and begins and ends on one, the plain expression
restricted to the hull's rows gives the bits it gives over every row, and
the prelude's tropopause eta is the JAX package's on the columns the card
tests hold the kernel to.  The plain versions of the sweeps take the plain
prelude, never the kernel's.
"""

import numpy as np
import pytest
import torch

from cloudsc2jax_torch.kernels import cloudsc2_kernel as kmod
from cloudsc2jax_torch.kernels import experiments as ex
from cloudsc2jax_torch.kernels import schedules as sch
from cloudsc2jax_torch.kernels import tlad_kernel as tk
from cloudsc2jax_torch.state import Cloudsc2State

import prelude_cases as cases

DTYPES = [torch.float32, torch.float64]


def _band_levels(ceta, dtype):
    """Levels k <= nlev-2 whose eta lies in 0.1 < eta < 0.4, in ``dtype``,
    by numpy's comparison (not the one the hull is made with)."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    c = np.asarray(ceta, np.float64).astype(np_dtype)[:-1]
    return np.flatnonzero((c > np_dtype(0.1)) & (c < np_dtype(0.4))).tolist()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(cases.CETA))
def test_hull_holds_every_band_level(name, dtype):
    p = cases.params(name)
    k_lo, k_hi = kmod.tropopause_hull(p, dtype)
    band = _band_levels(p.ceta, dtype)
    if not band:
        assert (k_lo, k_hi) == (0, -1)
        return
    assert (k_lo, k_hi) == (band[0], band[-1])
    assert 0 <= k_lo <= k_hi <= len(p.ceta) - 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(cases.CETA))
def test_tropopause_eta_over_the_hull_rows_is_over_all_rows(name, dtype):
    p = cases.params(name)
    pt, ten_t = cases.columns(p, 301, dtype)
    ceta, _ = kmod.level_scalars(p, pt)
    ztp1 = pt + p.ptsphy * ten_t
    full = kmod.tropopause_eta_lm(ztp1, ceta)
    k_lo, k_hi = kmod.tropopause_hull(p, dtype)
    if k_lo > k_hi:
        assert torch.equal(full, torch.full_like(full, 0.1))
        return
    rows = slice(k_lo, k_hi + 2)
    assert torch.equal(kmod.tropopause_eta_lm(ztp1[rows], ceta[rows]), full)
    # the inputs reach the band: some column's eta is not the default
    assert (full != torch.tensor(0.1, dtype=dtype)).any()


def test_hull_follows_the_working_dtype():
    """An eta a hair inside an edge of the band is inside it in float64 and
    on the edge once rounded to float32: the hull is cached per dtype."""
    p = cases.params("rounding_at_the_edges")
    assert kmod.tropopause_hull(p, torch.float64) == (40, 91)
    assert kmod.tropopause_hull(p, torch.float32) == (41, 90)


def _inputs(pt, ten_t):
    none = kmod.Cloudsc2Inputs(*(None for _ in kmod.Cloudsc2Inputs._fields))
    return none._replace(pt=pt, ten_t=ten_t,
                         paph=pt.new_zeros(pt.shape[0] + 1, pt.shape[1]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(cases.CETA))
def test_kernel_prelude_is_jaxs_tropopause_eta(name, dtype):
    """The prelude's tropopause eta equals the JAX package's
    ``_tropopause_eta_lm`` bit for bit on the inputs the card test
    ``test_cuda_prelude_kernel_is_the_plain_expression`` moves to the card
    (JAX does not run there; the card test holds the kernel to this
    answer)."""
    import jax.numpy as jnp

    from cloudsc2jax.pallas.cloudsc2_kernel import _tropopause_eta_lm

    p = cases.params(name)
    pt, ten_t = cases.columns(p, cases.NCOL, dtype)
    got = kmod.kernel_prelude(_inputs(pt, ten_t), p).ztrpaus
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    ceta = jnp.asarray(p.ceta, np_dtype)
    ztp1 = jnp.asarray(pt.numpy()) + p.ptsphy * jnp.asarray(ten_t.numpy())
    want = np.asarray(_tropopause_eta_lm(ztp1, ceta))
    assert want.dtype == np_dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def plain_unit():
    """The dwarf's inputs on 3 CPU columns and, for the reverse sweeps,
    their tangents and checkpoints (computed with ``pre`` given)."""
    st = Cloudsc2State.load(cases.FIXTURES / "input.npz")
    x = st.device_kernel_inputs(3, dtype=torch.float64, device="cpu", pqs=True)
    _, dout, ckpts = tk.cloudsc2_tl_reference(x, st.params, dscale=0.01,
                                              pre=kmod.plain_prelude(x, st.params))
    return x, st.params, dout, ckpts


PLAIN_SWEEPS = {
    "nl": lambda x, p, d, c: kmod.cloudsc2_nl_reference(x, p),
    "fwd_ckpt": lambda x, p, d, c: kmod.cloudsc2_fwd_ckpt_reference(x, p),
    "tl": lambda x, p, d, c: tk.cloudsc2_tl_reference(x, p, dscale=0.01),
    "ad": lambda x, p, d, c: tk.cloudsc2_ad_reference(x, d, c, p),
    "ad_streams": lambda x, p, d, c: sch.cloudsc2_ad_streams_reference(x, d, c, p),
    "tlad_fused": lambda x, p, d, c: ex.cloudsc2_tlad_fused_reference(x, p),
}


@pytest.mark.parametrize("name", sorted(PLAIN_SWEEPS))
def test_the_plain_sweeps_take_the_plain_prelude(name, plain_unit, monkeypatch):
    """Without a ``pre``, each plain version computes :func:`plain_prelude`,
    never :func:`kernel_prelude`, which launches the prelude's kernel on the
    card: a kernel held to its plain version there is held to the plain
    tropopause eta, not to the prelude's kernel on both sides."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version called kernel_prelude")

    called = []
    plain = kmod.plain_prelude

    def counted(*args, **kwargs):
        called.append(1)
        return plain(*args, **kwargs)

    for mod in (kmod, tk, ex, sch):
        monkeypatch.setattr(mod, "kernel_prelude", refuse)
        monkeypatch.setattr(mod, "plain_prelude", counted)
    PLAIN_SWEEPS[name](*plain_unit)
    assert called


def test_kernel_prelude_on_the_cpu_is_the_plain_expression():
    p = cases.params("dwarf")
    pt, ten_t = cases.columns(p, 64, torch.float32)
    x = _inputs(pt, ten_t)
    launches = kmod.kernel_prelude.launches
    pre = kmod.kernel_prelude(x, p)
    assert kmod.kernel_prelude.launches == launches
    ceta, zscalm = kmod.level_scalars(p, pt)
    assert torch.equal(pre.ztrpaus,
                       kmod.tropopause_eta_lm(pt + p.ptsphy * ten_t, ceta))
    assert pre.ceta is ceta and pre.zscalm is zscalm
