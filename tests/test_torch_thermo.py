"""The port's statement functions (``cloudsc2jax_torch.thermo``) against
the JAX package's (``cloudsc2jax.thermo``) on the same numpy temperatures.

* every one of the 21 functions (and the ``foeeliq`` alias) over 150-350 K,
  with ``t == rtt`` and the mixed-phase band's edges among the points, in
  f64, element by element within 1e-14 relative (the two packages' libm
  ``exp`` differ in the last bit at most), under the IFS defaults and with
  RTICECU moved so that the convective functions differ from the others;
* the unit cases of ``tests/test_physics_units.py`` for these functions
  (non-circular identities: derivatives by autodiff, cross-function
  identities, numpy transcriptions of the Fortran), run on the port as one
  parametrised test.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cloudsc2jax import thermo as jthermo
from cloudsc2jax.constants import Params as JParams
from cloudsc2jax_torch import thermo
from cloudsc2jax_torch.convert import params_from_jax

RTOL = 1e-14

# name -> the constant groups it takes after t
SIGNATURES = {
    "foedelta": ("cst",), "foeew": ("cst", "thf"), "foede": ("cst", "thf"),
    "foedesu": ("cst", "thf"), "foelh": ("cst", "thf"), "foeldcp": ("cst", "thf"),
    "foealfa": ("thf",), "foeewm": ("cst", "thf"), "foe_dewm_dt": ("cst", "thf"),
    "foedem": ("thf",), "foeldcpm": ("thf",), "foelhm": ("cst", "thf"),
    "foetb": ("cst", "thf"), "foealfcu": ("thf",), "foeewmcu": ("cst", "thf"),
    "foedemcu": ("thf",), "foeldcpmcu": ("thf",), "foelhmcu": ("cst", "thf"),
    "foeewmo": ("cst", "thf"), "foeeliq": ("cst", "thf"), "foeeice": ("cst", "thf"),
    "fokoop": ("cst", "thf"),
}


def _cu(p):
    """RTICECU 10 K below RTICE, so that the convective (KFLAG=1) functions
    differ from the stratiform ones (``tests/test_physics_units.py``)."""
    thf = p.yoethf
    return p.replace(yoethf=dataclasses.replace(
        thf, rticecu=thf.rtice - 10.0,
        rtwat_rticecu_r=1.0 / (thf.rtwat - (thf.rtice - 10.0))))


@pytest.fixture(scope="module")
def both():
    """variant -> (JAX params, port params)."""
    jp = JParams.ifs_defaults(ceta=np.linspace(0.005, 1.0, 10))
    return {"ifs": (jp, params_from_jax(jp)), "cu": (_cu(jp), params_from_jax(_cu(jp)))}


def _args(p, groups):
    return [p.yomcst if g == "cst" else p.yoethf for g in groups]


def test_the_port_has_every_function():
    assert thermo.__all__ == jthermo.__all__ == list(SIGNATURES)


@pytest.mark.parametrize("variant", ["ifs", "cu"])
@pytest.mark.parametrize("name", list(SIGNATURES))
def test_thermo_matches_jax(both, name, variant):
    import jax.numpy as jnp

    jp, tp = both[variant]
    cst, thf = tp.yomcst, tp.yoethf
    t = np.concatenate([np.linspace(150.0, 350.0, 401),
                        [cst.rtt, thf.rtice, thf.rtwat, thf.rticecu,
                         np.nextafter(cst.rtt, 0.0), np.nextafter(cst.rtt, 400.0)]])
    groups = SIGNATURES[name]
    theirs = np.asarray(getattr(jthermo, name)(jnp.asarray(t), *_args(jp, groups)))
    mine = getattr(thermo, name)(torch.from_numpy(t), *_args(tp, groups))
    assert mine.dtype == torch.float64 and mine.shape == t.shape
    np.testing.assert_allclose(mine.numpy(), theirs, rtol=RTOL, atol=0.0)


# ------------------------------------------ tests/test_physics_units.py:216-381
def _grad(f, t):
    """d f / dT at each point of ``t`` by reverse mode."""
    return torch.func.vmap(torch.func.grad(f))(t)


def _foedelta_and_foeew_phase_split(cst, thf):
    t = torch.tensor([cst.rtt - 5.0, cst.rtt + 5.0, cst.rtt], dtype=torch.float64)
    assert thermo.foedelta(t, cst).tolist() == [0.0, 1.0, 1.0]
    warm, cold = t[1], t[0]
    assert float(thermo.foeew(warm, cst, thf)) == pytest.approx(
        float(thermo.foeeliq(warm, cst, thf)), rel=1e-14)
    assert float(thermo.foeew(cold, cst, thf)) == pytest.approx(
        float(thermo.foeeice(cold, cst, thf)), rel=1e-14)


def _foedesu_is_dlog_foeew_dt(cst, thf):
    t = torch.tensor([210.0, 250.0, 280.0, 300.0], dtype=torch.float64)
    ad = _grad(lambda x: torch.log(thermo.foeew(x, cst, thf)), t)
    np.testing.assert_allclose(thermo.foedesu(t, cst, thf).numpy(), ad.numpy(),
                               rtol=1e-12)


def _foede_is_foedesu_times_foeldcp(cst, thf):
    t = torch.tensor([205.0, 255.0, 275.0, 305.0], dtype=torch.float64)
    np.testing.assert_allclose(
        thermo.foede(t, cst, thf).numpy(),
        (thermo.foedesu(t, cst, thf) * thermo.foeldcp(t, cst, thf)).numpy(),
        rtol=1e-12)


def _foelh_foeldcp_phase_values(cst, thf):
    warm, cold = (torch.tensor(v, dtype=torch.float64) for v in (280.0, 260.0))
    assert float(thermo.foelh(warm, cst, thf)) == cst.rlvtt
    assert float(thermo.foelh(cold, cst, thf)) == cst.rlstt
    assert float(thermo.foeldcp(warm, cst, thf)) == pytest.approx(
        cst.rlvtt / cst.rcpd, rel=1e-12)
    assert float(thermo.foeldcp(cold, cst, thf)) == pytest.approx(
        cst.rlstt / cst.rcpd, rel=1e-12)


def _foetb_is_dlog_foeewm_outside_mixed_band(cst, thf):
    warm = torch.tensor([thf.rtwat + 2.0, 300.0], dtype=torch.float64)
    cold = torch.tensor([210.0, thf.rtice - 2.0], dtype=torch.float64)
    ad_w = _grad(lambda x: torch.log(thermo.foeeliq(x, cst, thf)), warm)
    ad_c = _grad(lambda x: torch.log(thermo.foeeice(x, cst, thf)), cold)
    np.testing.assert_allclose(thermo.foetb(warm, cst, thf).numpy(), ad_w.numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(thermo.foetb(cold, cst, thf).numpy(), ad_c.numpy(),
                               rtol=1e-12)


def _foedem_is_dlog_ew_times_ldcp_in_pure_phases(cst, thf):
    warm = torch.tensor(thf.rtwat + 3.0, dtype=torch.float64)
    cold = torch.tensor(thf.rtice - 3.0, dtype=torch.float64)
    dlog_w = torch.func.grad(lambda x: torch.log(thermo.foeeliq(x, cst, thf)))(warm)
    dlog_c = torch.func.grad(lambda x: torch.log(thermo.foeeice(x, cst, thf)))(cold)
    assert float(thermo.foedem(warm, thf)) == pytest.approx(
        float(dlog_w) * thf.ralvdcp, rel=1e-12)
    assert float(thermo.foedem(cold, thf)) == pytest.approx(
        float(dlog_c) * thf.ralsdcp, rel=1e-12)


def _foeldcpm_foelhm_blend(cst, thf):
    warm, cold = (torch.tensor(v, dtype=torch.float64) for v in (300.0, 220.0))
    assert float(thermo.foelhm(warm, cst, thf)) == cst.rlvtt
    assert float(thermo.foelhm(cold, cst, thf)) == cst.rlstt
    t = torch.linspace(245.0, 280.0, 15, dtype=torch.float64)
    np.testing.assert_allclose(thermo.foeldcpm(t, thf).numpy(),
                               (thermo.foelhm(t, cst, thf) / cst.rcpd).numpy(),
                               rtol=1e-12)


def _foealfcu_matches_fortran_formula(cst, thf):
    t = np.linspace(230.0, 290.0, 31)
    expect = np.minimum(
        1.0,
        ((np.maximum(thf.rticecu, np.minimum(thf.rtwat, t)) - thf.rticecu)
         * thf.rtwat_rticecu_r) ** 2)
    np.testing.assert_allclose(thermo.foealfcu(torch.from_numpy(t), thf).numpy(),
                               expect, rtol=1e-14)
    assert float(thermo.foealfcu(torch.tensor(200.0, dtype=torch.float64), thf)) == 0.0
    assert float(thermo.foealfcu(torch.tensor(300.0, dtype=torch.float64), thf)) == 1.0


def _cu_functions_blend_with_foealfcu(cst, thf):
    t = torch.linspace(235.0, 285.0, 21, dtype=torch.float64)
    alfa = thermo.foealfcu(t, thf)
    np.testing.assert_allclose(
        thermo.foeewmcu(t, cst, thf).numpy(),
        (alfa * thermo.foeeliq(t, cst, thf)
         + (1 - alfa) * thermo.foeeice(t, cst, thf)).numpy(), rtol=1e-14)
    np.testing.assert_allclose(thermo.foelhmcu(t, cst, thf).numpy(),
                               (alfa * cst.rlvtt + (1 - alfa) * cst.rlstt).numpy(),
                               rtol=1e-14)
    np.testing.assert_allclose(thermo.foeldcpmcu(t, thf).numpy(),
                               (thermo.foelhmcu(t, cst, thf) / cst.rcpd).numpy(),
                               rtol=1e-12)
    warm = torch.tensor(thf.rtwat + 3.0, dtype=torch.float64)
    dlog_w = torch.func.grad(lambda x: torch.log(thermo.foeeliq(x, cst, thf)))(warm)
    assert float(thermo.foedemcu(warm, thf)) == pytest.approx(
        float(dlog_w) * thf.ralvdcp, rel=1e-12)
    tm = torch.tensor(thf.rtice - 5.0, dtype=torch.float64)
    assert float(thermo.foeewmcu(tm, cst, thf)) != pytest.approx(
        float(thermo.foeewm(tm, cst, thf)), rel=1e-10)


def _fokoop_matches_fortran_formula(cst, thf):
    t = np.asarray([200.0, 230.0, 255.0, 273.16, 290.0])
    eliq = thf.r2es * np.exp(thf.r3les * (t - cst.rtt) / (t - thf.r4les))
    eice = thf.r2es * np.exp(thf.r3ies * (t - cst.rtt) / (t - thf.r4ies))
    expect = np.minimum(thf.rkoop1 - thf.rkoop2 * t, eliq / eice)
    np.testing.assert_allclose(thermo.fokoop(torch.from_numpy(t), cst, thf).numpy(),
                               expect, rtol=1e-13)
    rtt = torch.tensor(cst.rtt, dtype=torch.float64)
    assert float(thermo.fokoop(rtt, cst, thf)) == pytest.approx(1.0)


def _foe_dewm_dt_is_derivative(cst, thf):
    t = torch.cat([torch.linspace(200.0, thf.rtice - 1.0, 12, dtype=torch.float64),
                   torch.linspace(thf.rtwat + 1.0, 310.0, 12, dtype=torch.float64)])
    ad = _grad(lambda x: thermo.foeewm(x, cst, thf), t)
    np.testing.assert_allclose(ad.numpy(), thermo.foe_dewm_dt(t, cst, thf).numpy(),
                               rtol=1e-10)


UNIT_CASES = {
    "foedelta_and_foeew_phase_split": (_foedelta_and_foeew_phase_split, "ifs"),
    "foedesu_is_dlog_foeew_dt": (_foedesu_is_dlog_foeew_dt, "ifs"),
    "foede_is_foedesu_times_foeldcp": (_foede_is_foedesu_times_foeldcp, "ifs"),
    "foelh_foeldcp_phase_values": (_foelh_foeldcp_phase_values, "ifs"),
    "foetb_is_dlog_foeewm_outside_mixed_band":
        (_foetb_is_dlog_foeewm_outside_mixed_band, "ifs"),
    "foedem_is_dlog_ew_times_ldcp_in_pure_phases":
        (_foedem_is_dlog_ew_times_ldcp_in_pure_phases, "ifs"),
    "foeldcpm_foelhm_blend": (_foeldcpm_foelhm_blend, "ifs"),
    "foealfcu_matches_fortran_formula": (_foealfcu_matches_fortran_formula, "cu"),
    "cu_functions_blend_with_foealfcu": (_cu_functions_blend_with_foealfcu, "cu"),
    "fokoop_matches_fortran_formula": (_fokoop_matches_fortran_formula, "ifs"),
    "foe_dewm_dt_is_derivative": (_foe_dewm_dt_is_derivative, "ifs"),
}


@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_thermo_unit_cases(both, case):
    fn, variant = UNIT_CASES[case]
    tp = both[variant][1]
    fn(tp.yomcst, tp.yoethf)
