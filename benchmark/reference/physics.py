"""The plain reference of CLOUDSC2: SATUR, the nonlinear scheme, and the
TL+AD work unit by ``torch.func.jvp`` and ``vjp``.

A frozen copy, in plain PyTorch, of the upstream dwarf's ``satur.F90``,
``cloudsc2.F90`` (LPHYLIN on, the ``lregcl`` regularisations of
``cloudsc2tl.F90``/``cloudsc2ad.F90``) and of the unit of
``cloudsc_driver_ad_mod.F90:158-237``.  It imports nothing of the system
under test and takes nothing it made: every field is a ``(ncol, nlev)``
tensor (``paph`` ``(ncol, nlev+1)``) that the benchmark generated, and
every constant comes from :mod:`benchmark.reference.constants`.  Every
data-dependent branch is a select; max and min are JAX's (the larger
operand's tangent, an exact tie split evenly).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import torch

from . import constants

# the inputs in the drivers' order (cloudsc_driver_tl_mod.F90:156-171)
INPUTS = ("paph", "pap", "pq", "pqs", "pt", "pl", "pi", "plude", "plu",
          "pmfu", "pmfd", "ten_t", "ten_q", "ten_l", "ten_i", "psupsat")
# the 10 outputs of the standard contract (cloudsc_driver_tl_mod.F90:235-244)
OUTPUTS = ("tenl_t", "tenl_q", "tenl_l", "tenl_i", "pclc", "pfplsl",
           "pfplsn", "pfhpsl", "pfhpsn", "pcovptot")

_ZSCAL = 0.9
_ZQMAX = 0.5
_ZEPS1 = 1.0e-12
_ZEPS2 = 1.0e-10


def consts(ptsphy: float, levapls2: bool = False) -> SimpleNamespace:
    """The frozen constants as attribute groups, with the time step."""
    groups = {k: SimpleNamespace(**v) for k, v in constants.GROUPS.items()}
    return SimpleNamespace(**groups, ptsphy=float(ptsphy),
                           levapls2=bool(levapls2))


class _Damp(torch.autograd.Function):
    """Identity on the primal; tangent and cotangent times ``factor``."""

    @staticmethod
    def forward(x, factor):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, factor = inputs
        if isinstance(factor, torch.Tensor):
            ctx.save_for_forward(factor)
            ctx.save_for_backward(factor)
            ctx.factor = None
        else:
            ctx.factor = factor

    @staticmethod
    def jvp(ctx, dx, dfactor):
        return dx * (ctx.factor if ctx.factor is not None else ctx.saved_tensors[0])

    @staticmethod
    def backward(ctx, g):
        f = ctx.factor if ctx.factor is not None else ctx.saved_tensors[0]
        return g * f, None


def _maximum(a, b):
    return torch.where(a > b, a, torch.where(a < b, b, (a + b) * 0.5))


def _minimum(a, b):
    return torch.where(a < b, a, torch.where(a > b, b, (a + b) * 0.5))


def satur(pap, t, c: SimpleNamespace):
    """Saturation specific humidity, LPHYLIN branch (satur.F90:106-123)."""
    cst, thf = c.yomcst, c.yoethf
    alfa = torch.clamp_max(
        ((torch.clamp(t, min=thf.rtice, max=thf.rtwat) - thf.rtice)
         * thf.rtwat_rtice_r) ** 2, 1.0)
    ew_liq = thf.r2es * torch.exp(thf.r3les * (t - cst.rtt) / (t - thf.r4les))
    ew_ice = thf.r2es * torch.exp(thf.r3ies * (t - cst.rtt) / (t - thf.r4ies))
    qs = torch.clamp_max((alfa * ew_liq + (1.0 - alfa) * ew_ice) / pap, _ZQMAX)
    return qs / (1.0 - cst.retv * qs)


def _crit_rel_humidity(ceta_k, zeta3):
    """Critical relative humidity profile (cloudsc2.F90:384-399)."""
    zrh2 = (0.35 + 0.14 * ((zeta3 - 0.25) / 0.15) ** 2
            + 0.04 * torch.clamp_max(zeta3 - 0.25, 0.0) / 0.15)
    zdeta2 = 0.3
    zdeta1 = 0.09 + 0.16 * (0.4 - zeta3) / 0.3
    blend_lo = 1.0 + (zrh2 - 1.0) * ((ceta_k - zeta3) / zdeta2)
    blend_hi = 1.0 + (zrh2 - 1.0) * torch.sqrt(
        torch.clamp_min((1.0 - ceta_k) / zdeta1, 0.0))
    return torch.where(
        ceta_k < zeta3, 1.0,
        torch.where(ceta_k < zeta3 + zdeta2, blend_lo,
                    torch.where(ceta_k < 1.0 - zdeta1, zrh2, blend_hi)))


def cloudsc2(x: Dict[str, torch.Tensor], ceta: torch.Tensor, c: SimpleNamespace,
             *, lregcl: bool = False, ldrain1d: bool = False) -> Dict[str, torch.Tensor]:
    """Nonlinear CLOUDSC2 over ``(ncol, nlev)`` fields in their dtype;
    returns the 10 outputs by name (cloudsc2.F90:235-735)."""
    cst, thf, cldp, phli = c.yomcst, c.yoethf, c.yrecldp, c.yrephli
    ptsphy = c.ptsphy
    pt, paph = x["pt"], x["paph"]
    ncol, nlev = pt.shape
    ceta = ceta.to(device=pt.device, dtype=pt.dtype)
    one = torch.ones_like(pt[:, 0])
    evap = bool(c.levapls2) or ldrain1d

    def reg(v, factor):
        return _Damp.apply(v, factor) if lregcl else v

    def sel(cond, a, b):
        return torch.where(cond, one * a, one * b)

    zckcodtl = 2.0 * cldp.rkconv * ptsphy
    zckcodti = 5.0 * cldp.rkconv * ptsphy
    zcons2 = 1.0 / (ptsphy * cst.rg)
    zcons3 = cst.rlvtt / cst.rcpd
    zmeltp2 = cst.rtt + 2.0
    zqtmst = 1.0 / ptsphy

    ztp1 = pt + ptsphy * x["ten_t"]
    zqp1 = x["pq"] + ptsphy * x["ten_q"] + x["psupsat"]
    zl = x["pl"] + ptsphy * x["ten_l"]
    zi = x["pi"] + ptsphy * x["ten_i"]
    zscalm = _ZSCAL * torch.clamp_min(ceta - 0.2, _ZEPS1) ** 0.2
    zdp = paph[:, 1:] - paph[:, :-1]
    zzz = 1.0 / (cst.rcpd + cst.rcpd * thf.rvtmp2 * zqp1)
    zlfdcp = cst.rlmlt * zzz
    zlsdcp = cst.rlstt * zzz
    zlvdcp = cst.rlvtt * zzz

    # tropopause eta (cloudsc2.F90:314-326): piecewise constant, no tangent
    mask = (ceta[:-1] > 0.1) & (ceta[:-1] < 0.4) & (ztp1[:, :-1] > ztp1[:, 1:])
    ztrpaus = torch.where(mask, ceta[:-1].detach()[None, :], 0.1).amax(dim=-1)
    paph_sfc = paph[:, nlev]

    zrfl = zsfl = zcovptot = torch.zeros_like(one)
    ys = {k: [] for k in ("tenl_t", "tenl_q", "tenl_l", "tenl_i", "pclc",
                          "pcovptot", "rfln", "sfln")}
    for k in range(nlev):
        ceta_k, zscalm_k = ceta[k], zscalm[k]
        ztp1_k, zqp1_k, zl_k, zi_k = ztp1[:, k], zqp1[:, k], zl[:, k], zi[:, k]
        pap_k, pqs_k, plude_k = x["pap"][:, k], x["pqs"][:, k], x["plude"][:, k]
        plu_k1 = x["plu"][:, k + 1] if k + 1 < nlev else torch.zeros_like(one)
        pmfu_k, pmfd_k, zdp_k = x["pmfu"][:, k], x["pmfd"][:, k], zdp[:, k]
        zlfdcp_k, zlsdcp_k, zlvdcp_k = zlfdcp[:, k], zlsdcp[:, k], zlvdcp[:, k]

        # 3.1 dqs/dT correction factor, LPHYLIN (cloudsc2.F90:343-408)
        zoealfaw = 0.545 * (torch.tanh(0.17 * (ztp1_k - phli.rlptrc)) + 1.0)
        cold = ztp1_k < cst.rtt
        zfwat = torch.where(cold, zoealfaw, one)
        z3es = sel(cold, thf.r3ies, thf.r3les)
        z4es = sel(cold, thf.r4ies, thf.r4les)
        zfoeew = thf.r2es * torch.exp(z3es * (ztp1_k - cst.rtt) / (ztp1_k - z4es))
        zesdp = zfoeew / pap_k
        zesdp = torch.where(zesdp > _ZQMAX, one * _ZQMAX, zesdp)
        zfacw = thf.r5les / (ztp1_k - thf.r4les) ** 2
        zfaci = thf.r5ies / (ztp1_k - thf.r4ies) ** 2
        zfac = zfwat * zfacw + (1.0 - zfwat) * zfaci
        zcor = 1.0 / (1.0 - cst.retv * zesdp)
        zdqsdtemp = zfac * zcor * pqs_k
        zcorqs = 1.0 + zcons3 * zdqsdtemp
        zqlim = torch.where(zqp1_k > pqs_k, pqs_k, zqp1_k)
        zcrh2 = _crit_rel_humidity(ceta_k, ztrpaus)
        zsupsat_fac = torch.where(ztp1_k < thf.rtice, 1.8 - 3.0e-3 * ztp1_k, one)
        zqsat = pqs_k * zsupsat_fac
        zqcrit = zcrh2 * zqsat

        # uniform-PDF cloud cover (cloudsc2.F90:412-427)
        zqt = zqp1_k + zl_k + zi_k
        zqpd = zqsat - zqt
        zqcd = zqsat - zqcrit
        mid = (zqt > zqcrit) & (zqt < zqsat)
        denom_safe = torch.where(mid, zqcd - zscalm_k * (zqt - zqcrit), one)
        ratio = torch.where(mid, zqpd, denom_safe) / denom_safe
        pclc_mid = 1.0 - torch.sqrt(_maximum(ratio, one * 0.0))
        if lregcl:
            # cloud-fraction tangent scaled by ZYYY (cloudsc2tl.F90:574-580)
            zrat = torch.clamp(zqpd / torch.where(mid, zqcd, one), 0.0, 1.0)
            zyyy = _minimum(
                one * 0.3,
                3.5 * torch.sqrt(zrat * (1.0 - zscalm_k * (1.0 - zrat)) ** 3)
                / (1.0 - zscalm_k))
            pclc_mid = _Damp.apply(pclc_mid, zyyy)
        zqc_mid = (zscalm_k * zqpd + (1.0 - zscalm_k) * zqcd) * pclc_mid ** 2
        saturated = zqt >= zqsat
        pclc = torch.where(mid, pclc_mid, torch.where(saturated, one, 0.0))
        zqc = torch.where(mid, zqc_mid,
                          torch.where(saturated, (1.0 - zscalm_k) * zqcd, 0.0))

        # convective detrainment (cloudsc2.F90:431-444)
        zgdp = cst.rg / zdp_k
        zlude = plude_k * ptsphy * zgdp
        llo1 = (k < nlev - 1) & (zlude >= cldp.rlmin) & (plu_k1 >= _ZEPS2)
        plu_safe = torch.where(llo1, plu_k1, one)
        pclc = torch.where(
            llo1, pclc + (1.0 - pclc) * (1.0 - torch.exp(-zlude / plu_safe)), pclc)
        zqc = torch.where(llo1, zqc + zlude, zqc)

        # compensating subsidence (cloudsc2.F90:448-460)
        zrho = pap_k / (cst.rd * ztp1_k)
        zrodqsdp = -zrho * pqs_k / (pap_k - cst.retv * zfoeew)
        zldcp = zfwat * zlvdcp_k + (1.0 - zfwat) * zlsdcp_k
        zfac3 = 1.0 / (1.0 + zldcp * zdqsdtemp)
        dtdzmo = cst.rg * (1.0 / cst.rcpd - zldcp * zrodqsdp) * zfac3
        zdqsdz = zdqsdtemp * dtdzmo - cst.rg * zrodqsdp
        zdqc_sub = zdqsdz * (pmfu_k + pmfd_k) * ptsphy / zrho
        zdqc = torch.where(zdqc_sub < zqc, reg(zdqc_sub, 0.1), zqc)
        zqc = zqc - zdqc

        # condensation rates (cloudsc2.F90:464-469)
        zqlwc = zqc * zfwat
        zqiwc = zqc * (1.0 - zfwat)
        zcondl = (zqlwc - zl_k) * zqtmst
        zcondi = (zqiwc - zi_k) * zqtmst

        # max-overlap precipitation fraction (cloudsc2.F90:475-481)
        zcovptot = _maximum(zcovptot, pclc)
        zcovpclr = _maximum(zcovptot - pclc, one * 0.0)

        # melting of incoming snow (cloudsc2.F90:487-498)
        zcons = zcons2 * zdp_k / zlfdcp_k
        zsnmlt = _minimum(zsfl, zcons * _maximum(one * 0.0, ztp1_k - zmeltp2))
        zrfln = zrfl + zsnmlt
        zsfln = zsfl - zsnmlt
        ztp1_k = ztp1_k - zsnmlt / zcons

        # rain and snow production (cloudsc2.F90:504-534)
        active = pclc > _ZEPS2
        pclc_safe = torch.where(active, pclc, one)
        zlcrit_l = 1.9 * cldp.rclcrit if evap else 2.0 * cldp.rclcrit
        zcldl = zqlwc / pclc_safe
        zdl = reg(zckcodtl * (1.0 - torch.exp(-((zcldl / zlcrit_l) ** 2))), 0.01)
        zprr = torch.where(active, zqlwc - pclc * zcldl * torch.exp(-zdl), 0.0)
        zqlwc = zqlwc - zprr
        zlcrit_i = 1.0e-4 if evap else 2.0 * cldp.rclcrit
        zcldi = zqiwc / pclc_safe
        zdi = reg(zckcodti * torch.exp(0.025 * (ztp1_k - cst.rtt))
                  * (1.0 - torch.exp(-((zcldi / zlcrit_i) ** 2))), 0.01)
        zprs = torch.where(active, zqiwc - pclc * zcldi * torch.exp(-zdi), 0.0)
        zqiwc = zqiwc - zprs

        # new precipitation and freezing split (cloudsc2.F90:538-552)
        zdr = zcons2 * zdp_k * (zprr + zprs)
        cold = ztp1_k < cst.rtt
        zrfreeze = torch.where(cold, zcons2 * zdp_k * zprr, 0.0)
        zfwatr = torch.where(cold, 0.0, one)
        zrfln = zrfln + zfwatr * zdr
        zsfln = zsfln + (1.0 - zfwatr) * zdr

        # clear-sky precipitation evaporation (cloudsc2.F90:556-591)
        zprtot = zrfln + zsfln
        if evap:
            llo2 = (zprtot > _ZEPS2) & (zcovpclr > _ZEPS2)
            covptot_safe = torch.where(llo2, zcovptot, one)
            covpclr_safe = torch.where(llo2, zcovpclr, one)
            one_m_clc = torch.where(llo2, (1.0 - pclc) ** 2, one)
            zpreclr = zprtot * zcovpclr / covptot_safe
            zqe = pqs_k - (pqs_k - zqlim) * zcovpclr / one_m_clc
            zbeta_arg = torch.where(
                llo2, torch.sqrt(pap_k / paph_sfc) / 5.09e-3 * zpreclr / covpclr_safe,
                one)
            zbeta = cst.rg * cldp.rpecons * zbeta_arg ** 0.5777
            zb = ptsphy * zbeta * (pqs_k - zqe) / (1.0 + zbeta * ptsphy * zcorqs)
            zdpr = _minimum(zcovpclr * zb / (ptsphy * cst.rg / zdp_k), zpreclr)
            zcovptot_new = torch.where(zpreclr - zdpr <= 0.0, pclc, zcovptot)
            zcovptot = torch.where(llo2, zcovptot_new, zcovptot)
            pcovptot_k = torch.where(llo2, zcovptot, 0.0)
            prtot_safe = torch.where(llo2, zprtot, one)
            zevapr = torch.where(llo2, zdpr * zrfln / prtot_safe, 0.0)
            zevaps = torch.where(llo2, zdpr * zsfln / prtot_safe, 0.0)
            zrfln = zrfln - zevapr
            zsfln = zsfln - zevaps
        else:
            pcovptot_k = zevapr = zevaps = torch.zeros_like(zprtot)

        # tendencies and first-guess T, q (cloudsc2.F90:601-618)
        def tendencies(condl, condi, rfreeze):
            dqdt = -(condl + condi) + (plude_k + zevapr + zevaps) * zgdp
            dtdt = (zlvdcp_k * condl + zlsdcp_k * condi
                    - (zlvdcp_k * zevapr + zlsdcp_k * zevaps
                       + plude_k * (zfwat * zlvdcp_k + (1.0 - zfwat) * zlsdcp_k)
                       - (zlsdcp_k - zlvdcp_k) * rfreeze) * zgdp)
            return dqdt, dtdt

        zdqdt, zdtdt = tendencies(zcondl, zcondi, zrfreeze)
        ztp1_k = ztp1_k + ptsphy * zdtdt
        zqp1_k = zqp1_k + ptsphy * zdqdt
        zqold = zqp1_k

        # clipping of the final humidity: CUADJTQS, 2 iterations
        # (cloudsc2.F90:628-669)
        liquid = ztp1_k > cst.rtt
        z3es = sel(liquid, thf.r3les, thf.r3ies)
        z4es = sel(liquid, thf.r4les, thf.r4ies)
        z5alcp = sel(liquid, thf.r5alvcp, thf.r5alscp)
        zaldcp = sel(liquid, thf.ralvdcp, thf.ralsdcp)
        zqp = 1.0 / pap_k
        for _ in range(2):
            zqsat_a = zqp * (thf.r2es * torch.exp(
                z3es * (ztp1_k - cst.rtt) / (ztp1_k - z4es)))
            zqsat_a = torch.where(zqsat_a > _ZQMAX, one * _ZQMAX, zqsat_a)
            zcor_a = 1.0 / (1.0 - cst.retv * zqsat_a)
            zqsat_a = zqsat_a * zcor_a
            z2s = z5alcp / (ztp1_k - z4es) ** 2
            zcond1 = (zqp1_k - zqsat_a) / (1.0 + zqsat_a * zcor_a * z2s)
            ztp1_k = ztp1_k + zaldcp * zcond1
            zqp1_k = zqp1_k - zcond1

        # post-adjustment precipitation and freezing (cloudsc2.F90:672-692)
        diff = zqold - zqp1_k
        zdq = torch.where(diff >= 0.0, reg(diff, 0.7), torch.zeros_like(diff))
        zdr2 = zcons2 * zdp_k * zdq
        cold2 = ztp1_k < cst.rtt
        zfwatr = torch.where(cold2, 0.0, one)
        zcondl = zcondl + zfwatr * zdq * zqtmst
        zcondi = zcondi + (1.0 - zfwatr) * zdq * zqtmst
        zrfln = zrfln + zfwatr * zdr2
        zsfln = zsfln + (1.0 - zfwatr) * zdr2
        zrfreeze = zrfreeze + torch.where(cold2, zfwat * zdr2, 0.0)

        # the level's outputs (cloudsc2.F90:694-716)
        zdqdt, zdtdt = tendencies(zcondl, zcondi, zrfreeze)
        for name, v in (("tenl_t", zdtdt), ("tenl_q", zdqdt),
                        ("tenl_l", (zqlwc - zl_k) * zqtmst),
                        ("tenl_i", (zqiwc - zi_k) * zqtmst), ("pclc", pclc),
                        ("pcovptot", pcovptot_k), ("rfln", zrfln), ("sfln", zsfln)):
            ys[name].append(v)
        zrfl, zsfl = zrfln, zsfln

    y = {k: torch.stack(v, dim=1) for k, v in ys.items()}
    top = torch.zeros_like(y["rfln"][:, :1])
    pfplsl = torch.cat([top, y.pop("rfln")], dim=1)
    pfplsn = torch.cat([top, y.pop("sfln")], dim=1)
    # enthalpy fluxes (cloudsc2.F90:730-735)
    return {**y, "pfplsl": pfplsl, "pfplsn": pfplsn,
            "pfhpsl": -pfplsl * cst.rlvtt, "pfhpsn": -pfplsn * cst.rlstt}


def nl(x, ceta, c, *, ldrain1d=False):
    """The forecast's sweep: qsat is SATUR of pt and pap (the dwarf's
    driver, cloudsc_driver_mod.F90:91-92), then CLOUDSC2."""
    return cloudsc2({**x, "pqs": satur(x["pap"], x["pt"], c)}, ceta, c,
                    ldrain1d=ldrain1d)


def tlad(x, ceta, c, *, dscale, lregcl=True, ldrain1d=False):
    """The TL+AD work unit (cloudsc_driver_ad_mod.F90:158-237): the
    increments ``dscale·x`` of all 16 inputs through the tangent-linear,
    the 10-field tangent image back through the adjoint.  Returns
    ``(outputs, tangents, adjoints)``, dicts by name."""
    names = tuple(x)

    def f(*fields):
        out = cloudsc2(dict(zip(names, fields)), ceta, c, lregcl=lregcl,
                       ldrain1d=ldrain1d)
        return tuple(out[k] for k in OUTPUTS)

    primal = tuple(x.values())
    out, dout = torch.func.jvp(f, primal, tuple(dscale * v for v in primal))
    _, vjp_fn = torch.func.vjp(f, *primal)
    adj = vjp_fn(dout)
    return (dict(zip(OUTPUTS, out)), dict(zip(OUTPUTS, dout)),
            dict(zip(names, adj)))
