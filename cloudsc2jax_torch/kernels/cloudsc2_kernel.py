"""The fused SATUR + CLOUDSC2 nonlinear sweep: CUDA kernel and plain version.

Port of :mod:`cloudsc2jax.pallas.cloudsc2_kernel` (the ``_stream_kernel``
path with ``fuse_satur=True``: qsat is always SATUR of pt and pap, computed
level by level, and ``inputs.pqs`` is never read).  The TPU kernel streamed ``(nlev, nb, S,
128)`` blocks; that array is, byte for byte, the levels-major ``(nlev,
ncol)`` array, which the port keeps from input generation to validation
with no column padding.

* :func:`cloudsc2_nl` is the wrapper.  A CUDA tensor goes to the hand-written
  kernel ``csrc/cloudsc2_nl.cu`` (one thread per column, the level loop
  and the rfl/sfl/covptot carry in registers); a CPU tensor goes to the
  plain version; any other device raises.
* :func:`cloudsc2_nl_reference` is the plain PyTorch version: a Python
  loop over levels calling :func:`level_physics`, a line-by-line port of
  ``_level_physics``.
* :func:`kernel_prelude` computes, in the working dtype and before the
  launch, the per-level and per-column scalars the kernel takes (ceta,
  zscalm, the tropopause eta, the surface pressure), as ``_Layout`` does.
* :func:`unblock_outputs` turns the 8 raw streams into the
  :class:`Cloudsc2Outputs` contract (zero top flux row, enthalpy fluxes)
  as ``(ncol, nlev)`` views of the levels-major tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..constants import Params
from ..physics.cloudsc2 import (
    Cloudsc2Inputs,
    Cloudsc2Outputs,
    _ZEPS1,
    _ZEPS2,
    _ZQMAX,
    _ZSCAL,
    _crit_rel_humidity,
)
from ..physics.satur import satur

__all__ = [
    "Cloudsc2StreamOutputs",
    "KernelPrelude",
    "cloudsc2_nl",
    "cloudsc2_nl_reference",
    "kernel_prelude",
    "launch_cloudsc2_nl",
    "level_physics",
    "tropopause_eta_lm",
    "unblock_outputs",
]

# raw per-level streams of the plain version's level body, in order
_LEVEL_FIELDS = (
    "pt", "pq", "pqs", "pap", "pl", "pi", "plude", "pmfu", "pmfd",
    "ten_t", "ten_q", "ten_l", "ten_i", "psupsat",
)

# Argument arrays of the C launcher; the names and order are those of the
# enums Stream, Output and Const in csrc/cloudsc2_nl.cu.  The kernel
# computes pqs in registers, so it reads no pqs stream.
KERNEL_STREAMS = tuple(n for n in _LEVEL_FIELDS if n != "pqs") + (
    "plu", "paph", "ceta", "zscalm", "ztrpaus", "paph_sfc",
)
KERNEL_OUTPUTS = (
    "tenl_t", "tenl_q", "tenl_l", "tenl_i", "pclc", "pcovptot", "rfln", "sfln",
)
KERNEL_CONSTANTS = (
    "ptsphy", "rg", "rd", "rcpd", "retv", "rlvtt", "rlstt", "rlmlt", "rtt",
    "rcpd_rvtmp2", "inv_rcpd", "zcons2", "zcons3", "zmeltp2", "zqtmst",
    "zckcodtl", "zckcodti", "zlcrit_l", "zlcrit_i", "rlmin", "rg_rpecons",
    "ptsphy_rg", "rlptrc", "r2es", "r3les", "r3ies", "r4les", "r4ies",
    "r5les", "r5ies", "r5alvcp", "r5alscp", "ralvdcp", "ralsdcp", "rtice",
    "rtwat", "rtwat_rtice_r",
)


class Cloudsc2StreamOutputs(NamedTuple):
    """The kernel's 8 raw output streams, levels-major ``(nlev, ncol)``
    (the counterpart of ``Cloudsc2BlockedOutputs``)."""

    tenl_t: torch.Tensor
    tenl_q: torch.Tensor
    tenl_l: torch.Tensor
    tenl_i: torch.Tensor
    pclc: torch.Tensor
    pcovptot: torch.Tensor
    rfln: torch.Tensor
    sfln: torch.Tensor


class KernelPrelude(NamedTuple):
    """Scalars computed before the launch, in the working dtype."""

    ceta: torch.Tensor  # (nlev,)
    zscalm: torch.Tensor  # (nlev,)
    ztrpaus: torch.Tensor  # (ncol,)
    paph_sfc: torch.Tensor  # (ncol,)


def _evap(params: Params, ldrain1d: bool) -> bool:
    return bool(params.yophnc.levapls2) or ldrain1d


def _check_config(params: Params, ldrain1d: bool) -> None:
    if not (bool(params.yrephli.lphylin) or ldrain1d):
        # the level body hardcodes the LPHYLIN dqs/dT branch (the reference
        # entry programs force LPHYLIN=.TRUE., dwarf_cloudsc.F90:107)
        raise NotImplementedError(
            "cloudsc2_nl implements the LPHYLIN=True configuration only"
        )


def level_physics(params: Params, ldrain1d: bool, scalars, fields, cols, carry):
    """One level of CLOUDSC2 on ``(ncol,)`` tensors (``lregcl=False``).

    ``scalars`` = (ceta_k, zscalm_k, not_last) with the first two 0-d
    tensors of the working dtype and ``not_last`` a bool; ``fields`` = the
    14 raw level rows + (plu_k1, paph_lo, paph_hi); ``cols`` = (ztrpaus,
    paph_sfc); ``carry`` = (zrfl, zsfl, zcovptot).  Returns (outputs,
    new_carry).  Line references cite src/cloudsc2_nl/cloudsc2.F90.
    """
    cst, thf = params.yomcst, params.yoethf
    cldp, phli, phnc = params.yrecldp, params.yrephli, params.yophnc
    ptsphy = params.ptsphy

    ceta_k, zscalm_k, not_last = scalars
    (pt, pq, pqs, pap, pl_, pi_, plude, pmfu, pmfd,
     ten_t, ten_q, ten_l, ten_i, psupsat, plu_k1, paph_lo, paph_hi) = fields
    ztrpaus, paph_sfc = cols
    zrfl, zsfl, zcovptot = carry

    one = torch.ones_like(pt)

    def sel(cond, a: float, b: float):
        """where(cond, a, b) for two Python floats, in the working dtype."""
        return torch.where(cond, torch.full_like(pt, a), b)

    zckcodtl = 2.0 * cldp.rkconv * ptsphy
    zckcodti = 5.0 * cldp.rkconv * ptsphy
    zcons2 = 1.0 / (ptsphy * cst.rg)
    zcons3 = cst.rlvtt / cst.rcpd
    zmeltp2 = cst.rtt + 2.0
    zqtmst = 1.0 / ptsphy

    # first-guess state (:253-260) and layer thickness (:272)
    ztp1 = pt + ptsphy * ten_t
    zqp1 = pq + ptsphy * ten_q + psupsat
    zl = pl_ + ptsphy * ten_l
    zi = pi_ + ptsphy * ten_i
    zdp = paph_hi - paph_lo

    # latent-heat factors (:272-277)
    zzz = 1.0 / (cst.rcpd + cst.rcpd * thf.rvtmp2 * zqp1)
    zlfdcp = cst.rlmlt * zzz
    zlsdcp = cst.rlstt * zzz
    zlvdcp = cst.rlvtt * zzz

    # --- 3.1 dqs/dT (LPHYLIN branch, :349-364)
    zoealfaw = 0.545 * (torch.tanh(0.17 * (ztp1 - phli.rlptrc)) + 1.0)
    cold = ztp1 < cst.rtt
    zfwat = torch.where(cold, zoealfaw, one)
    z3es = sel(cold, thf.r3ies, thf.r3les)
    z4es = sel(cold, thf.r4ies, thf.r4les)
    zfoeew = thf.r2es * torch.exp(z3es * (ztp1 - cst.rtt) / (ztp1 - z4es))
    zesdp = torch.clamp_max(zfoeew / pap, _ZQMAX)
    zfacw = thf.r5les / (ztp1 - thf.r4les) ** 2
    zfaci = thf.r5ies / (ztp1 - thf.r4ies) ** 2
    zfac = zfwat * zfacw + (1.0 - zfwat) * zfaci
    zcor = 1.0 / (1.0 - cst.retv * zesdp)
    zdqsdtemp = zfac * zcor * pqs
    zcorqs = 1.0 + zcons3 * zdqsdtemp
    zqlim = torch.where(zqp1 > pqs, pqs, zqp1)

    zcrh2 = _crit_rel_humidity(ceta_k, ztrpaus)
    zsupsat_fac = torch.where(ztp1 < thf.rtice, 1.8 - 3.0e-3 * ztp1, one)
    zqsat = pqs * zsupsat_fac
    zqcrit = zcrh2 * zqsat

    # --- cloud cover (:412-427)
    zqt = zqp1 + zl + zi
    zqpd = zqsat - zqt
    zqcd = zqsat - zqcrit
    mid = (zqt > zqcrit) & (zqt < zqsat)
    denom = zqcd - zscalm_k * (zqt - zqcrit)
    denom_safe = torch.where(mid, denom, one)
    ratio = torch.where(mid, zqpd, denom_safe) / denom_safe
    pclc_mid = 1.0 - torch.sqrt(torch.clamp_min(ratio, 0.0))
    zqc_mid = (zscalm_k * zqpd + (1.0 - zscalm_k) * zqcd) * pclc_mid ** 2
    saturated = zqt >= zqsat
    pclc = torch.where(mid, pclc_mid, torch.where(saturated, one, 0.0))
    zqc = torch.where(
        mid, zqc_mid, torch.where(saturated, (1.0 - zscalm_k) * zqcd, 0.0)
    )

    # --- convective detrainment (:431-444)
    zgdp = cst.rg / zdp
    zlude = plude * ptsphy * zgdp
    llo1 = (zlude >= cldp.rlmin) & (plu_k1 >= _ZEPS2) & bool(not_last)
    plu_safe = torch.where(llo1, plu_k1, one)
    pclc = torch.where(
        llo1, pclc + (1.0 - pclc) * (1.0 - torch.exp(-zlude / plu_safe)), pclc
    )
    zqc = torch.where(llo1, zqc + zlude, zqc)

    # --- compensating subsidence (:448-460)
    zrho = pap / (cst.rd * ztp1)
    zrodqsdp = -zrho * pqs / (pap - cst.retv * zfoeew)
    zldcp = zfwat * zlvdcp + (1.0 - zfwat) * zlsdcp
    zfac3 = 1.0 / (1.0 + zldcp * zdqsdtemp)
    dtdzmo = cst.rg * (1.0 / cst.rcpd - zldcp * zrodqsdp) * zfac3
    zdqsdz = zdqsdtemp * dtdzmo - cst.rg * zrodqsdp
    zdqc_sub = zdqsdz * (pmfu + pmfd) * ptsphy / zrho
    # MIN tie convention (cloudsc2tl.F90:651-661)
    zqc = zqc - torch.where(zdqc_sub < zqc, zdqc_sub, zqc)

    # --- condensation rates (:464-469)
    zqlwc = zqc * zfwat
    zqiwc = zqc * (1.0 - zfwat)
    zcondl = (zqlwc - zl) * zqtmst
    zcondi = (zqiwc - zi) * zqtmst

    # --- precip overlap (:475-481)
    zcovptot = torch.maximum(zcovptot, pclc)
    zcovpclr = torch.clamp_min(zcovptot - pclc, 0.0)

    # --- snow melt (:487-498)
    zcons = zcons2 * zdp / zlfdcp
    zsnmlt = torch.minimum(zsfl, zcons * torch.clamp_min(ztp1 - zmeltp2, 0.0))
    zrfln = zrfl + zsnmlt
    zsfln = zsfl - zsnmlt
    ztp1 = ztp1 - zsnmlt / zcons

    # --- autoconversion (:504-534)
    levapls2 = bool(phnc.levapls2)
    active = pclc > _ZEPS2
    pclc_safe = torch.where(active, pclc, one)
    zlcrit_l = 1.9 * cldp.rclcrit if (levapls2 or ldrain1d) else 2.0 * cldp.rclcrit
    zcldl = zqlwc / pclc_safe
    zdl = zckcodtl * (1.0 - torch.exp(-((zcldl / zlcrit_l) ** 2)))
    zlnew = pclc * zcldl * torch.exp(-zdl)
    zprr = torch.where(active, zqlwc - zlnew, 0.0)
    zqlwc = zqlwc - zprr

    zlcrit_i = 1.0e-4 if (levapls2 or ldrain1d) else 2.0 * cldp.rclcrit
    zcldi = zqiwc / pclc_safe
    zdi = (
        zckcodti
        * torch.exp(0.025 * (ztp1 - cst.rtt))
        * (1.0 - torch.exp(-((zcldi / zlcrit_i) ** 2)))
    )
    zinew = pclc * zcldi * torch.exp(-zdi)
    zprs = torch.where(active, zqiwc - zinew, 0.0)
    zqiwc = zqiwc - zprs

    # --- freezing split (:538-552)
    zdr = zcons2 * zdp * (zprr + zprs)
    cold = ztp1 < cst.rtt
    zrfreeze = torch.where(cold, zcons2 * zdp * zprr, 0.0)
    zfwatr = torch.where(cold, 0.0, one)
    zrfln = zrfln + zfwatr * zdr
    zsfln = zsfln + (1.0 - zfwatr) * zdr

    # --- clear-sky precip evaporation (:556-591)
    zprtot = zrfln + zsfln
    if levapls2 or ldrain1d:
        llo2 = (zprtot > _ZEPS2) & (zcovpclr > _ZEPS2)
        covptot_safe = torch.where(llo2, zcovptot, one)
        covpclr_safe = torch.where(llo2, zcovpclr, one)
        one_m_clc = torch.where(llo2, (1.0 - pclc) ** 2, one)
        zpreclr = zprtot * zcovpclr / covptot_safe
        zqe = pqs - (pqs - zqlim) * zcovpclr / one_m_clc
        zbeta_arg = torch.where(
            llo2,
            torch.sqrt(pap / paph_sfc) / 5.09e-3 * zpreclr / covpclr_safe,
            one,
        )
        zbeta = cst.rg * cldp.rpecons * zbeta_arg ** 0.5777
        zb = ptsphy * zbeta * (pqs - zqe) / (1.0 + zbeta * ptsphy * zcorqs)
        zdtgdp = ptsphy * cst.rg / zdp
        zdpr = torch.minimum(zcovpclr * zb / zdtgdp, zpreclr)
        zpreclr2 = zpreclr - zdpr
        zcovptot_new = torch.where(zpreclr2 <= 0.0, pclc, zcovptot)
        zcovptot = torch.where(llo2, zcovptot_new, zcovptot)
        pcov = torch.where(llo2, zcovptot, 0.0)
        prtot_safe = torch.where(llo2, zprtot, one)
        zevapr = torch.where(llo2, zdpr * zrfln / prtot_safe, 0.0)
        zevaps = torch.where(llo2, zdpr * zsfln / prtot_safe, 0.0)
        zrfln = zrfln - zevapr
        zsfln = zsfln - zevaps
    else:
        pcov = torch.zeros_like(zprtot)
        zevapr = torch.zeros_like(zprtot)
        zevaps = torch.zeros_like(zprtot)

    # --- tendencies + first guess (:601-618)
    def tend(condl, condi, rfreeze):
        dqdt = -(condl + condi) + (plude + zevapr + zevaps) * zgdp
        dtdt = (
            zlvdcp * condl
            + zlsdcp * condi
            - (
                zlvdcp * zevapr
                + zlsdcp * zevaps
                + plude * (zfwat * zlvdcp + (1.0 - zfwat) * zlsdcp)
                - (zlsdcp - zlvdcp) * rfreeze
            )
            * zgdp
        )
        return dqdt, dtdt

    zdqdt, zdtdt = tend(zcondl, zcondi, zrfreeze)
    ztp1 = ztp1 + ptsphy * zdtdt
    zqp1 = zqp1 + ptsphy * zdqdt
    zqold = zqp1

    # --- inlined saturation adjustment (:628-669)
    liquid = ztp1 > cst.rtt
    z3es = sel(liquid, thf.r3les, thf.r3ies)
    z4es = sel(liquid, thf.r4les, thf.r4ies)
    z5alcp = sel(liquid, thf.r5alvcp, thf.r5alscp)
    zaldcp = sel(liquid, thf.ralvdcp, thf.ralsdcp)
    zqp = 1.0 / pap
    for _ in range(2):
        foeew_a = thf.r2es * torch.exp(z3es * (ztp1 - cst.rtt) / (ztp1 - z4es))
        qsat_a = torch.clamp_max(zqp * foeew_a, _ZQMAX)
        cor_a = 1.0 / (1.0 - cst.retv * qsat_a)
        qsat_a = qsat_a * cor_a
        z2s = z5alcp / (ztp1 - z4es) ** 2
        cond1 = (zqp1 - qsat_a) / (1.0 + qsat_a * cor_a * z2s)
        ztp1 = ztp1 + zaldcp * cond1
        zqp1 = zqp1 - cond1

    # --- post-adjustment accounting (:672-692)
    diff = zqold - zqp1
    zdq = torch.where(diff >= 0.0, diff, 0.0)
    zdr2 = zcons2 * zdp * zdq
    cold2 = ztp1 < cst.rtt
    zrfreeze2 = torch.where(cold2, zfwat * zdr2, 0.0)
    zfwatr = torch.where(cold2, 0.0, one)
    zcondl = zcondl + zfwatr * zdq * zqtmst
    zcondi = zcondi + (1.0 - zfwatr) * zdq * zqtmst
    zrfln = zrfln + zfwatr * zdr2
    zsfln = zsfln + (1.0 - zfwatr) * zdr2
    zrfreeze = zrfreeze + zrfreeze2

    zdqdt, zdtdt = tend(zcondl, zcondi, zrfreeze)

    outputs = (
        zdtdt,
        zdqdt,
        (zqlwc - zl) * zqtmst,
        (zqiwc - zi) * zqtmst,
        pclc,
        pcov,
        zrfln,
        zsfln,
    )
    return outputs, (zrfln, zsfln, zcovptot)


def tropopause_eta_lm(ztp1_lm, ceta):
    """Tropopause eta, levels leading: ``(nlev, ...)`` any trailing shape
    (cloudsc2.F90:314-326).  The deepest level in the 0.1<eta<0.4 band
    with a temperature inversion wins: a masked max over levels."""
    sl = (slice(None),) + (None,) * (ztp1_lm.dim() - 1)
    band = ((ceta[:-1] > 0.1) & (ceta[:-1] < 0.4))[sl]
    mask = band & (ztp1_lm[:-1] > ztp1_lm[1:])
    cand = torch.where(mask, ceta[:-1][sl], 0.1)
    return cand.amax(dim=0)


def kernel_prelude(inputs: Cloudsc2Inputs, params: Params) -> KernelPrelude:
    """ceta, zscalm, the tropopause eta and the surface pressure, in the
    working dtype on the inputs' device (``_Layout.__init__``, :582-591)."""
    pt = inputs.pt
    nlev = pt.shape[0]
    ceta = torch.tensor(params.ceta, dtype=pt.dtype, device=pt.device)
    zscalm = _ZSCAL * torch.clamp_min(ceta - 0.2, _ZEPS1) ** 0.2
    ztp1 = pt + params.ptsphy * inputs.ten_t
    return KernelPrelude(
        ceta=ceta,
        zscalm=zscalm,
        ztrpaus=tropopause_eta_lm(ztp1, ceta),
        paph_sfc=inputs.paph[nlev],
    )


def cloudsc2_nl_reference(
    inputs: Cloudsc2Inputs, params: Params, *, ldrain1d: bool = False,
) -> Cloudsc2StreamOutputs:
    """The plain PyTorch version of the sweep, on any device.

    ``inputs`` are levels-major (``(nlev, ncol)``, paph ``(nlev+1, ncol)``).
    qsat is computed from pt and pap level by level, as the kernel does;
    ``inputs.pqs`` is not read and may be ``None``.
    """
    _check_config(params, ldrain1d)
    pre = kernel_prelude(inputs, params)
    nlev = inputs.pt.shape[0]
    zero = torch.zeros_like(inputs.pt[0])
    carry = (zero, zero, zero)
    outs = [torch.empty_like(inputs.pt) for _ in Cloudsc2StreamOutputs._fields]
    cols = (pre.ztrpaus, pre.paph_sfc)
    for k in range(nlev):
        row = {name: getattr(inputs, name)[k]
               for name in _LEVEL_FIELDS if name != "pqs"}
        row["pqs"] = satur(row["pap"], row["pt"], params, lphylin=True, kflag=2)
        fields = tuple(row[name] for name in _LEVEL_FIELDS) + (
            inputs.plu[min(k + 1, nlev - 1)], inputs.paph[k], inputs.paph[k + 1],
        )
        scalars = (pre.ceta[k], pre.zscalm[k], k < nlev - 1)
        level_out, carry = level_physics(params, ldrain1d, scalars, fields,
                                         cols, carry)
        for buf, val in zip(outs, level_out):
            buf[k] = val
    return Cloudsc2StreamOutputs(*outs)


def _kernel_constants(params: Params, ldrain1d: bool):
    """KERNEL_CONSTANTS' values, each folded in double exactly as Python
    folds it in ``level_physics`` before it meets a tensor."""
    cst, thf = params.yomcst, params.yoethf
    cldp, phli = params.yrecldp, params.yrephli
    ptsphy = params.ptsphy
    evap = _evap(params, ldrain1d)
    values = {
        "ptsphy": ptsphy,
        "rg": cst.rg,
        "rd": cst.rd,
        "rcpd": cst.rcpd,
        "retv": cst.retv,
        "rlvtt": cst.rlvtt,
        "rlstt": cst.rlstt,
        "rlmlt": cst.rlmlt,
        "rtt": cst.rtt,
        "rcpd_rvtmp2": cst.rcpd * thf.rvtmp2,
        "inv_rcpd": 1.0 / cst.rcpd,
        "zcons2": 1.0 / (ptsphy * cst.rg),
        "zcons3": cst.rlvtt / cst.rcpd,
        "zmeltp2": cst.rtt + 2.0,
        "zqtmst": 1.0 / ptsphy,
        "zckcodtl": 2.0 * cldp.rkconv * ptsphy,
        "zckcodti": 5.0 * cldp.rkconv * ptsphy,
        "zlcrit_l": 1.9 * cldp.rclcrit if evap else 2.0 * cldp.rclcrit,
        "zlcrit_i": 1.0e-4 if evap else 2.0 * cldp.rclcrit,
        "rlmin": cldp.rlmin,
        "rg_rpecons": cst.rg * cldp.rpecons,
        "ptsphy_rg": ptsphy * cst.rg,
        "rlptrc": phli.rlptrc,
        "r2es": thf.r2es,
        "r3les": thf.r3les,
        "r3ies": thf.r3ies,
        "r4les": thf.r4les,
        "r4ies": thf.r4ies,
        "r5les": thf.r5les,
        "r5ies": thf.r5ies,
        "r5alvcp": thf.r5alvcp,
        "r5alscp": thf.r5alscp,
        "ralvdcp": thf.ralvdcp,
        "ralsdcp": thf.ralsdcp,
        "rtice": thf.rtice,
        "rtwat": thf.rtwat,
        "rtwat_rtice_r": thf.rtwat_rtice_r,
    }
    return [float(values[name]) for name in KERNEL_CONSTANTS]


def _load_kernel():
    from . import build

    lib = build.load_library("cloudsc2_nl")
    if not getattr(lib, "_cloudsc2_nl_bound", False):
        counts = (ctypes.c_int * 3)()
        lib.cloudsc2_nl_abi.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.cloudsc2_nl_abi.restype = ctypes.c_int
        lib.cloudsc2_nl_abi(counts)
        expected = (len(KERNEL_STREAMS), len(KERNEL_OUTPUTS),
                    len(KERNEL_CONSTANTS))
        if tuple(counts) != expected:
            raise RuntimeError(
                f"cloudsc2_nl.cu argument layout {tuple(counts)} does not "
                f"match the wrapper's {expected}"
            )
        for fn in (lib.cloudsc2_nl_f32, lib.cloudsc2_nl_f64):
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_void_p),  # in
                ctypes.POINTER(ctypes.c_void_p),  # out
                ctypes.POINTER(ctypes.c_double),  # consts
                ctypes.c_int, ctypes.c_int,  # ncol, nlev
                ctypes.c_int,  # evap
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int
        lib._cloudsc2_nl_bound = True
    return lib


def _check_kernel_operands(inputs: Cloudsc2Inputs, pre: KernelPrelude):
    pt = inputs.pt
    if pt.dim() != 2:
        raise ValueError(f"expected levels-major (nlev, ncol) inputs, got {tuple(pt.shape)}")
    nlev, ncol = pt.shape
    if pt.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cloudsc2_nl takes float32 or float64, got {pt.dtype}")
    shapes = dict.fromkeys(KERNEL_STREAMS, (nlev, ncol))
    shapes.update(paph=(nlev + 1, ncol), ceta=(nlev,), zscalm=(nlev,),
                  ztrpaus=(ncol,), paph_sfc=(ncol,))
    tensors = {**inputs._asdict(), **pre._asdict()}
    for name, shape in shapes.items():
        x = tensors[name]
        if x.device != pt.device or x.dtype != pt.dtype:
            raise ValueError(f"{name}: {x.dtype} on {x.device}, expected "
                             f"{pt.dtype} on {pt.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch_cloudsc2_nl(
    inputs: Cloudsc2Inputs, pre: KernelPrelude, params: Params, *,
    ldrain1d: bool = False,
) -> Cloudsc2StreamOutputs:
    """Launch the CUDA kernel on CUDA tensors, on the current stream.

    Checks device, dtype, shape and contiguity, allocates the 8 outputs,
    and raises if the launch is refused.  Counts each launch in
    ``cloudsc2_nl.launches``.
    """
    if inputs.pt.device.type != "cuda":
        raise ValueError(f"launch_cloudsc2_nl needs CUDA tensors, got {inputs.pt.device}")
    _check_config(params, ldrain1d)
    _check_kernel_operands(inputs, pre)
    lib = _load_kernel()
    nlev, ncol = inputs.pt.shape
    operands = {**inputs._asdict(), **pre._asdict()}
    outs = [torch.empty_like(inputs.pt) for _ in KERNEL_OUTPUTS]
    in_ptrs = (ctypes.c_void_p * len(KERNEL_STREAMS))(
        *(operands[name].data_ptr() for name in KERNEL_STREAMS))
    out_ptrs = (ctypes.c_void_p * len(KERNEL_OUTPUTS))(
        *(x.data_ptr() for x in outs))
    consts = (ctypes.c_double * len(KERNEL_CONSTANTS))(
        *_kernel_constants(params, ldrain1d))
    fn = lib.cloudsc2_nl_f32 if inputs.pt.dtype == torch.float32 \
        else lib.cloudsc2_nl_f64
    with torch.cuda.device(inputs.pt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(in_ptrs, out_ptrs, consts, ncol, nlev,
                 int(_evap(params, ldrain1d)), stream)
    if err != 0:
        raise RuntimeError(f"cloudsc2_nl kernel launch failed: cudaError_t {err}")
    cloudsc2_nl.launches += 1
    return Cloudsc2StreamOutputs(*outs)


def cloudsc2_nl(
    inputs: Cloudsc2Inputs, params: Params, *, ldrain1d: bool = False,
) -> Cloudsc2StreamOutputs:
    """The fused SATUR+CLOUDSC2 sweep on levels-major inputs.

    CUDA tensors run the hand-written kernel (:func:`launch_cloudsc2_nl`,
    after :func:`kernel_prelude`); CPU tensors run the plain version
    :func:`cloudsc2_nl_reference`; any other device raises.
    """
    device = inputs.pt.device
    if device.type == "cpu":
        return cloudsc2_nl_reference(inputs, params, ldrain1d=ldrain1d)
    if device.type != "cuda":
        raise ValueError(f"cloudsc2_nl runs on cuda or cpu tensors, not {device}")
    return launch_cloudsc2_nl(inputs, kernel_prelude(inputs, params), params,
                              ldrain1d=ldrain1d)


cloudsc2_nl.launches = 0


def unblock_outputs(out: Cloudsc2StreamOutputs, params: Params) -> Cloudsc2Outputs:
    """Raw streams -> the :class:`Cloudsc2Outputs` contract (flux top row +
    enthalpy fluxes, cloudsc2.F90:694-735), as ``(ncol, nlev[+1])`` views
    of levels-major tensors."""
    top = torch.zeros_like(out.rfln[:1])
    pfplsl = torch.cat([top, out.rfln], dim=0)
    pfplsn = torch.cat([top, out.sfln], dim=0)
    res = Cloudsc2Outputs(
        tenl_t=out.tenl_t, tenl_q=out.tenl_q, tenl_l=out.tenl_l,
        tenl_i=out.tenl_i, pclc=out.pclc,
        pfplsl=pfplsl, pfplsn=pfplsn,
        pfhpsl=-pfplsl * params.yomcst.rlvtt,
        pfhpsn=-pfplsn * params.yomcst.rlstt,
        pcovptot=out.pcovptot,
    )
    return Cloudsc2Outputs(*(x.T for x in res))
