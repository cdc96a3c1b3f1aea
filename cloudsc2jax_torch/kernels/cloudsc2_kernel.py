"""The CLOUDSC2 nonlinear sweeps: CUDA kernels and plain versions.

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
* :func:`cloudsc2_fwd_ckpt` is the wrapper of the checkpointing forward
  sweep, the port of ``cloudsc2jax.pallas.tlad_kernel._fwd_ckpt_kernel``:
  the same sweep with ``inputs.pqs`` READ as a stream (it is one of the
  differentiated inputs, so the adjoint's trajectory must use the caller's
  value) and the 3 carries going into each level written as checkpoints.
  Its kernel shares the hand-written level body
  (``csrc/cloudsc2_nl_sweep.cuh``); its plain version is
  :func:`cloudsc2_fwd_ckpt_reference`.
* :func:`kernel_prelude` computes, in the working dtype and before the
  launch, the per-level and per-column scalars the kernel takes (ceta,
  zscalm, the tropopause eta, the surface pressure), as ``_Layout`` does;
  on CUDA the tropopause eta is one launch of ``csrc/cloudsc2_prelude.cu``
  over the rows of the eta band's hull (:func:`tropopause_hull`).  The
  plain versions take :func:`plain_prelude`, the plain expression
  :func:`tropopause_eta_lm` on any device.
* :func:`unblock_outputs` turns the 8 raw streams into the
  :class:`Cloudsc2Outputs` contract (zero top flux row, enthalpy fluxes)
  as ``(ncol, nlev)`` views of the levels-major tensors, through
  :func:`assemble_contract`: on CUDA one launch of
  ``csrc/cloudsc2_contract.cu``, in place where the caller allocated the
  flux fields before the sweep (:func:`flux_rows`, :func:`flux_slots`: the
  sweeps write their flux rows into rows 1.. of them), else as a copy; on
  the CPU the plain expressions :func:`plain_contract`.

Every kernel here is reached through :func:`~cloudsc2jax_torch.kernels.
build.bind` and :func:`~cloudsc2jax_torch.kernels.build.launch`.  The
sweeps' other schedules live in :mod:`~cloudsc2jax_torch.kernels.schedules`,
the NL sweep's experiments in :mod:`~cloudsc2jax_torch.kernels.experiments`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from .. import spans
from ..constants import Params
from . import build
from ..ops import damp_tangent
from ..ops import maximum as _maximum
from ..ops import minimum as _minimum
from ..ops import power
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
    "FluxRows",
    "KernelPrelude",
    "assemble_contract",
    "check_operands",
    "cloudsc2_fwd_ckpt",
    "cloudsc2_fwd_ckpt_reference",
    "cloudsc2_nl",
    "cloudsc2_nl_reference",
    "contract_bytes",
    "flux_rows",
    "flux_seeds",
    "flux_slots",
    "kernel_prelude",
    "launch_cloudsc2_fwd_ckpt",
    "launch_cloudsc2_nl",
    "level_physics",
    "level_scalars",
    "output_buffers",
    "plain_contract",
    "plain_prelude",
    "tropopause_eta_lm",
    "tropopause_hull",
    "unblock_outputs",
]

# raw per-level streams of the plain version's level body, in order
_LEVEL_FIELDS = (
    "pt", "pq", "pqs", "pap", "pl", "pi", "plude", "pmfu", "pmfd",
    "ten_t", "ten_q", "ten_l", "ten_i", "psupsat",
)

# Argument arrays of the C launcher; the names and order are those of
# Order<false>, Output and Const in csrc/cloudsc2_nl_sweep.cuh.  The kernel
# computes pqs in registers, so it reads no pqs stream.
KERNEL_STREAMS = tuple(n for n in _LEVEL_FIELDS if n != "pqs") + (
    "plu", "paph", "ceta", "zscalm", "ztrpaus", "paph_sfc",
)
KERNEL_OUTPUTS = (
    "tenl_t", "tenl_q", "tenl_l", "tenl_i", "pclc", "pcovptot", "rfln", "sfln",
)
# the checkpointing sweep appends pqs to the streams and the 3 carry-in
# checkpoints to the outputs (kFwdStreams, kFwdOutputs in the source)
CHECKPOINTS = ("ckpt_rfl", "ckpt_sfl", "ckpt_covptot")
FWD_CKPT_STREAMS = KERNEL_STREAMS + ("pqs",)
FWD_CKPT_OUTPUTS = KERNEL_OUTPUTS + CHECKPOINTS
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


Checkpoints = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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


def level_physics(params: Params, ldrain1d: bool, scalars, fields, cols, carry,
                  lregcl: bool = False):
    """One level of CLOUDSC2 on ``(ncol,)`` tensors.

    ``scalars`` = (ceta_k, zscalm_k, not_last) with the first two 0-d
    tensors of the working dtype and ``not_last`` a bool or a 0-d bool
    tensor; ``fields`` = the 14 raw level rows + (plu_k1, paph_lo,
    paph_hi); ``cols`` = (ztrpaus, paph_sfc); ``carry`` = (zrfl, zsfl,
    zcovptot).  Returns (outputs, new_carry).  Line references cite
    src/cloudsc2_nl/cloudsc2.F90.

    ``lregcl`` injects the reference's TL/AD perturbation regularisations
    through :func:`cloudsc2jax_torch.ops.damp_tangent` (identity on this
    trajectory) at the five sites of ``_level_physics``: the ZYYY
    cloud-cover damp (cloudsc2tl.F90:574-580), 0.1x subsidence (:657), the
    two 1/100 autoconversion damps (:323-324 with :754 and :794) and 0.7x
    vapour clipping (:994-1001).

    Every max and min is :func:`~cloudsc2jax_torch.ops.maximum`/``minimum``, against a
    tensor of the constant where JAX writes a constant: their derivative
    is that of ``jnp.maximum``/``jnp.minimum``, a select that splits an
    exact tie evenly, where ``clamp_min``/``clamp_max`` would pass a tie
    whole.  The params may be Python floats or 0-d tensors (the derivative
    emitter traces them as inputs).
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
    reg = damp_tangent if lregcl else (lambda x, factor: x)

    def const(v: float):
        return torch.full_like(pt, v)

    def sel(cond, a, b):
        """where(cond, a, b) for two params, in the working dtype."""
        return torch.where(cond, one * a, one * b)

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
    zesdp = _minimum(zfoeew / pap, const(_ZQMAX))
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
    pclc_mid = 1.0 - torch.sqrt(_maximum(ratio, const(0.0)))
    if lregcl:
        # ZYYY cloud-fraction perturbation damp (cloudsc2tl.F90:574-580)
        zqcd_safe = torch.where(mid, zqcd, one)
        zrat = torch.clamp(zqpd / zqcd_safe, 0.0, 1.0)
        zyyy = _minimum(
            const(0.3),
            3.5 * torch.sqrt(zrat * (1.0 - zscalm_k * (1.0 - zrat)) ** 3)
            / (1.0 - zscalm_k),
        )
        pclc_mid = damp_tangent(pclc_mid, zyyy)
    zqc_mid = (zscalm_k * zqpd + (1.0 - zscalm_k) * zqcd) * pclc_mid ** 2
    saturated = zqt >= zqsat
    pclc = torch.where(mid, pclc_mid, torch.where(saturated, one, 0.0))
    zqc = torch.where(
        mid, zqc_mid, torch.where(saturated, (1.0 - zscalm_k) * zqcd, 0.0)
    )

    # --- convective detrainment (:431-444)
    zgdp = cst.rg / zdp
    zlude = plude * ptsphy * zgdp
    llo1 = not_last & (zlude >= cldp.rlmin) & (plu_k1 >= _ZEPS2)
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
    # MIN tie convention + 0.1x subsidence tangent damp under LREGCL
    # (cloudsc2tl.F90:651-661)
    zqc = zqc - torch.where(zdqc_sub < zqc, reg(zdqc_sub, 0.1), zqc)

    # --- condensation rates (:464-469)
    zqlwc = zqc * zfwat
    zqiwc = zqc * (1.0 - zfwat)
    zcondl = (zqlwc - zl) * zqtmst
    zcondi = (zqiwc - zi) * zqtmst

    # --- precip overlap (:475-481)
    zcovptot = _maximum(zcovptot, pclc)
    zcovpclr = _maximum(zcovptot - pclc, const(0.0))

    # --- snow melt (:487-498)
    zcons = zcons2 * zdp / zlfdcp
    zsnmlt = _minimum(zsfl, zcons * _maximum(const(0.0), ztp1 - zmeltp2))
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
    zdl = reg(zdl, 0.01)  # ZCKCODTLA=ZCKCODTL/100 (cloudsc2tl.F90:323,751-760)
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
    zdi = reg(zdi, 0.01)  # (cloudsc2tl.F90:324, 791-800)
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
        zbeta = cst.rg * cldp.rpecons * power(zbeta_arg, 0.5777)
        zb = ptsphy * zbeta * (pqs - zqe) / (1.0 + zbeta * ptsphy * zcorqs)
        zdtgdp = ptsphy * cst.rg / zdp
        zdpr = _minimum(zcovpclr * zb / zdtgdp, zpreclr)
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
        qsat_a = _minimum(zqp * foeew_a, const(_ZQMAX))
        cor_a = 1.0 / (1.0 - cst.retv * qsat_a)
        qsat_a = qsat_a * cor_a
        z2s = z5alcp / (ztp1 - z4es) ** 2
        cond1 = (zqp1 - qsat_a) / (1.0 + qsat_a * cor_a * z2s)
        ztp1 = ztp1 + zaldcp * cond1
        zqp1 = zqp1 - cond1

    # --- post-adjustment accounting (:672-692); clipping tangent damped
    # by 0.7 under LREGCL (cloudsc2tl.F90:994-1001)
    diff = zqold - zqp1
    zdq = torch.where(diff >= 0.0, reg(diff, 0.7), torch.zeros_like(diff))
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


def level_scalars(params: Params, like: torch.Tensor):
    """(ceta, zscalm), ``(nlev,)`` each, in ``like``'s dtype on its device.
    Made once per ceta, dtype and device and shared (read only), so that a
    call on a CUDA device copies nothing from the host and does not
    synchronise with it."""
    return _level_scalars(params.ceta, like.dtype, like.device)


@functools.lru_cache(maxsize=16)
def _level_scalars(ceta: Tuple[float, ...], dtype: torch.dtype,
                   device: torch.device):
    ceta = torch.tensor(ceta, dtype=dtype, device=device)
    return ceta, _ZSCAL * torch.clamp_min(ceta - 0.2, _ZEPS1) ** 0.2


def tropopause_hull(params: Params, dtype: torch.dtype) -> Tuple[int, int]:
    """``(k_lo, k_hi)``: the first and last level ``k <= nlev-2`` whose eta,
    in ``dtype``, lies in the band of :func:`tropopause_eta_lm` (the same
    comparison in the same dtype); ``(0, -1)`` where none does.  Only those
    levels can move the tropopause eta off 0.1, so it depends on the rows
    ``k_lo..k_hi+1`` of ``pt`` and ``ten_t`` alone.  Made once per ceta and
    dtype, on the host."""
    return _tropopause_hull(params.ceta, dtype)


@functools.lru_cache(maxsize=16)
def _tropopause_hull(ceta: Tuple[float, ...], dtype: torch.dtype):
    c = torch.tensor(ceta, dtype=dtype)[:-1]
    band = torch.nonzero((c > 0.1) & (c < 0.4)).flatten().tolist()
    return (band[0], band[-1]) if band else (0, -1)


_PRELUDE_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pt, ten_t, ceta
    ctypes.c_void_p,  # ztrpaus
    ctypes.c_double,  # ptsphy
    ctypes.c_int,  # ncol
    ctypes.c_longlong, ctypes.c_longlong,  # pt's row and column strides
    ctypes.c_longlong, ctypes.c_longlong,  # ten_t's row and column strides
    ctypes.c_int, ctypes.c_int,  # k_lo, k_hi
    ctypes.c_void_p,  # stream
]


def _load_prelude_kernel():
    return build.bind(
        "cloudsc2_prelude", {"cloudsc2_prelude_abi": (2, 1, 1)},
        {"cloudsc2_prelude_f32": _PRELUDE_ARGTYPES,
         "cloudsc2_prelude_f64": _PRELUDE_ARGTYPES})


def _launch_tropopause(pt: torch.Tensor, ten_t: torch.Tensor,
                       ceta: torch.Tensor, params: Params) -> torch.Tensor:
    """``csrc/cloudsc2_prelude.cu`` on the current stream: the tropopause
    eta ``(ncol,)`` of ``(nlev, ncol)`` CUDA ``pt`` and ``ten_t`` of one
    float32 or float64 dtype, in any layout (both strides are passed), read
    from the rows of the band's hull.  Raises for other dtypes, shapes or
    devices, where ceta has another number of levels than pt (the plain
    expression's broadcast raises there too), and if the launch is
    refused."""
    if pt.dtype not in (torch.float32, torch.float64) or ten_t.dtype != pt.dtype:
        raise TypeError(f"the prelude's kernel takes pt and ten_t of one float32 "
                        f"or float64 dtype, not {pt.dtype} and {ten_t.dtype}")
    if pt.dim() != 2 or ten_t.shape != pt.shape or ten_t.device != pt.device:
        raise ValueError(f"the prelude's kernel takes pt and ten_t of one (nlev, "
                         f"ncol) shape on one card, not {tuple(pt.shape)} on "
                         f"{pt.device} and {tuple(ten_t.shape)} on {ten_t.device}")
    if ceta.shape[0] != pt.shape[0]:
        raise ValueError(f"ceta has {ceta.shape[0]} levels, pt {pt.shape[0]}")
    k_lo, k_hi = tropopause_hull(params, pt.dtype)
    ncol = pt.shape[1]
    ztrpaus = torch.empty(ncol, dtype=pt.dtype, device=pt.device)
    build.launch(_load_prelude_kernel(), "cloudsc2_prelude", pt, pt, ten_t, ceta,
                 ztrpaus, float(params.ptsphy), ncol, *pt.stride(), *ten_t.stride(),
                 k_lo, k_hi)
    return ztrpaus


@spans.spanned("prelude")
def plain_prelude(inputs: Cloudsc2Inputs, params: Params) -> KernelPrelude:
    """:func:`kernel_prelude` by the plain expression, on any device: the
    tropopause eta is :func:`tropopause_eta_lm` over every level.  The
    plain versions' prelude, and what the kernel's is held to."""
    pt = inputs.pt
    ceta, zscalm = level_scalars(params, pt)
    return KernelPrelude(
        ceta=ceta,
        zscalm=zscalm,
        ztrpaus=tropopause_eta_lm(pt + params.ptsphy * inputs.ten_t, ceta),
        paph_sfc=inputs.paph[pt.shape[0]],
    )


@spans.spanned("prelude")
def kernel_prelude(inputs: Cloudsc2Inputs, params: Params) -> KernelPrelude:
    """ceta, zscalm, the tropopause eta and the surface pressure, in the
    working dtype on the inputs' device (``_Layout.__init__``, :582-591).

    On CUDA the tropopause eta is one launch of the hand-written kernel
    ``csrc/cloudsc2_prelude.cu`` (float32 or float64, any 2-D layout), which
    reads only the rows of :func:`tropopause_hull` and is counted in
    ``kernel_prelude.launches``; on the CPU this is :func:`plain_prelude`.
    Both give the same bits."""
    pt = inputs.pt
    if not pt.is_cuda:
        return plain_prelude(inputs, params)
    ceta, zscalm = level_scalars(params, pt)
    ztrpaus = _launch_tropopause(pt, inputs.ten_t, ceta, params)
    kernel_prelude.launches += 1
    return KernelPrelude(
        ceta=ceta,
        zscalm=zscalm,
        ztrpaus=ztrpaus,
        paph_sfc=inputs.paph[pt.shape[0]],
    )


kernel_prelude.launches = 0


def _nl_sweep(inputs: Cloudsc2Inputs, params: Params, ldrain1d: bool, *,
              pqs_stream: bool, checkpoints: bool,
              pre: "KernelPrelude | None" = None, out=None):
    """The level loop of the plain versions: (8 output streams, 3
    checkpoint streams | None).  ``pqs_stream`` reads ``inputs.pqs``;
    otherwise qsat is SATUR of pt and pap, level by level, as the NL kernel
    computes it.  ``checkpoints`` stores the carry going into each level.
    ``pre`` replaces :func:`plain_prelude` of ``inputs`` (the encoded sweep
    takes the tropopause eta and surface pressure of the exact inputs).
    ``out`` gives outputs by name, as to the kernels (:func:`output_buffers`)."""
    _check_config(params, ldrain1d)
    if pre is None:
        pre = plain_prelude(inputs, params)
    nlev = inputs.pt.shape[0]
    zero = torch.zeros_like(inputs.pt[0])
    carry = (zero, zero, zero)
    outs = output_buffers(KERNEL_OUTPUTS, out, inputs.pt, "the plain sweep")
    ckpts = (tuple(torch.empty_like(inputs.pt) for _ in CHECKPOINTS)
             if checkpoints else None)
    cols = (pre.ztrpaus, pre.paph_sfc)
    for k in range(nlev):
        row = {name: getattr(inputs, name)[k]
               for name in _LEVEL_FIELDS if pqs_stream or name != "pqs"}
        if not pqs_stream:
            row["pqs"] = satur(row["pap"], row["pt"], params, lphylin=True,
                               kflag=2)
        fields = tuple(row[name] for name in _LEVEL_FIELDS) + (
            inputs.plu[min(k + 1, nlev - 1)], inputs.paph[k], inputs.paph[k + 1],
        )
        if checkpoints:
            for buf, val in zip(ckpts, carry):
                buf[k] = val
        scalars = (pre.ceta[k], pre.zscalm[k], k < nlev - 1)
        level_out, carry = level_physics(params, ldrain1d, scalars, fields,
                                         cols, carry)
        for buf, val in zip(outs, level_out):
            buf[k] = val
    return Cloudsc2StreamOutputs(*outs), ckpts


@spans.spanned("nl_sweep")
def cloudsc2_nl_reference(
    inputs: Cloudsc2Inputs, params: Params, *, ldrain1d: bool = False,
    out=None,
) -> Cloudsc2StreamOutputs:
    """The plain PyTorch version of the sweep, on any device.

    ``inputs`` are levels-major (``(nlev, ncol)``, paph ``(nlev+1, ncol)``).
    qsat is computed from pt and pap level by level, as the kernel does;
    ``inputs.pqs`` is not read and may be ``None``.  ``out`` as for
    :func:`cloudsc2_nl`.
    """
    return _nl_sweep(inputs, params, ldrain1d, pqs_stream=False,
                     checkpoints=False, out=out)[0]


@spans.spanned("fwd_sweep")
def cloudsc2_fwd_ckpt_reference(
    inputs: Cloudsc2Inputs, params: Params, *, ldrain1d: bool = False,
    pre: "KernelPrelude | None" = None, out=None,
) -> Tuple[Cloudsc2StreamOutputs, Checkpoints]:
    """The plain PyTorch version of the checkpointing forward sweep, on any
    device: ``(outputs, checkpoints)``.  ``inputs.pqs`` is read as it is;
    ``checkpoints`` are the carries (rfl, sfl, covptot) going INTO each
    level, ``(nlev, ncol)`` each.  ``pre`` replaces :func:`plain_prelude`
    of ``inputs`` where the caller has it; ``out`` as for
    :func:`cloudsc2_nl`."""
    if inputs.pqs is None:
        raise ValueError("the checkpointing forward sweep reads pqs")
    return _nl_sweep(inputs, params, ldrain1d, pqs_stream=True,
                     checkpoints=True, pre=pre, out=out)


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


_NL_ARGTYPES = [
    ctypes.POINTER(ctypes.c_void_p),  # in
    ctypes.POINTER(ctypes.c_void_p),  # out
    ctypes.POINTER(ctypes.c_double),  # consts
    ctypes.c_int, ctypes.c_int,  # ncol, nlev
    ctypes.c_int,  # evap
    ctypes.c_void_p,  # stream
]


def _load_kernel():
    n_out, n_const = len(KERNEL_OUTPUTS), len(KERNEL_CONSTANTS)
    return build.bind(
        "cloudsc2_nl",
        {"cloudsc2_nl_abi": (len(KERNEL_STREAMS), n_out, n_const),
         "cloudsc2_fwd_ckpt_abi": (len(FWD_CKPT_STREAMS), len(FWD_CKPT_OUTPUTS),
                                   n_const)},
        {**{f"{entry}_{suffix}": _NL_ARGTYPES
            for entry in ("cloudsc2_nl", "cloudsc2_fwd_ckpt")
            for suffix in ("f32", "f64")},
         # the stamped twin's: the warps' records before the stream
         **{f"cloudsc2_nl_stamped_{suffix}": _NL_ARGTYPES[:-1] + [ctypes.c_void_p] * 2
            for suffix in ("f32", "f64")},
         **build.occupancy_queries("cloudsc2_nl", 1),  # evap
         **build.occupancy_queries("cloudsc2_nl_stamped", 1)})


def check_operands(tensors, names, like: torch.Tensor, what: str) -> None:
    """Raise unless every ``tensors[name]`` of ``names`` is a contiguous
    tensor with ``like``'s device and dtype (float32 or float64) and the
    kernels' shape for it: ``(nlev, ncol)`` for a level stream, ``(nlev+1,
    ncol)`` for paph, ``(nlev,)`` for ceta and zscalm, ``(ncol,)`` for
    ztrpaus and paph_sfc, where ``(nlev, ncol)`` is ``like``'s shape."""
    if like.dim() != 2:
        raise ValueError(f"expected levels-major (nlev, ncol) inputs, got {tuple(like.shape)}")
    if like.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} takes float32 or float64, got {like.dtype}")
    nlev, ncol = like.shape
    special = dict(paph=(nlev + 1, ncol), ceta=(nlev,), zscalm=(nlev,),
                   ztrpaus=(ncol,), paph_sfc=(ncol,))
    for name in names:
        x, shape = tensors[name], special.get(name, (nlev, ncol))
        if x.device != like.device or x.dtype != like.dtype:
            raise ValueError(f"{name}: {x.dtype} on {x.device}, expected "
                             f"{like.dtype} on {like.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def output_buffers(names, out, like: torch.Tensor, what: str):
    """One ``(nlev, ncol)`` output like ``like`` per name of ``names``:
    ``out[name]`` where the caller gives it (checked as
    :func:`check_operands` checks a level stream; a row view of a wider
    levels-major tensor, such as :func:`flux_slots`, is contiguous), else a
    new tensor.  Raises for a name of ``out`` that is not in ``names``."""
    out = dict(out or {})
    unknown = sorted(set(out) - set(names))
    if unknown:
        raise ValueError(f"{what} writes no output {', '.join(unknown)}")
    if out:
        check_operands(out, tuple(out), like, what)
    return [out[n] if n in out else torch.empty_like(like) for n in names]


def _launch(entry: str, streams, outputs, inputs: Cloudsc2Inputs,
            pre: KernelPrelude, params: Params, ldrain1d: bool,
            library=_load_kernel, extra=(), out=None):
    """Check the operands named by ``streams``, take the ``(nlev, ncol)``
    outputs named by ``outputs`` from ``out`` or allocate them
    (:func:`output_buffers`), and launch ``<entry>_f32|f64`` of the library
    ``library()`` binds (``csrc/cloudsc2_nl.cu`` unless given) on the
    current stream, ``extra`` going between ``evap`` and the stream; raises
    if refused."""
    if inputs.pt.device.type != "cuda":
        raise ValueError(f"launch_{entry} needs CUDA tensors, got {inputs.pt.device}")
    _check_config(params, ldrain1d)
    operands = {**inputs._asdict(), **pre._asdict()}
    check_operands(operands, streams, inputs.pt, entry)
    nlev, ncol = inputs.pt.shape
    outs = output_buffers(outputs, out, inputs.pt, entry)
    consts = (ctypes.c_double * len(KERNEL_CONSTANTS))(
        *_kernel_constants(params, ldrain1d))
    build.launch(library(), entry, inputs.pt,
                 [operands[name] for name in streams], outs, consts, ncol, nlev,
                 int(_evap(params, ldrain1d)), *extra)
    return outs


@spans.spanned("nl_sweep")
def launch_cloudsc2_nl(
    inputs: Cloudsc2Inputs, pre: KernelPrelude, params: Params, *,
    ldrain1d: bool = False, out=None,
) -> Cloudsc2StreamOutputs:
    """Launch the CUDA kernel on CUDA tensors, on the current stream.

    Checks device, dtype, shape and contiguity, allocates the 8 outputs but
    those ``out`` gives by name (the flux rows of :func:`flux_slots`), and
    raises if the launch is refused.  Counts each launch in
    ``cloudsc2_nl.launches``, and gives the ``nl_sweep`` span the counters
    of the instance (:func:`~cloudsc2jax_torch.kernels.build.sweep_occupancy`)
    and ``evap``: 1 where it ran the evaporating body.  In the recorded calls
    that stamp it launches the kernel's twin that stamps each warp
    (:func:`~cloudsc2jax_torch.spans.stamped`).
    """
    entry, stamps = spans.stamped("cloudsc2_nl", inputs.pt, inputs.pt.shape[-1])
    outs = _launch(entry, KERNEL_STREAMS, KERNEL_OUTPUTS, inputs,
                   pre, params, ldrain1d, extra=stamps, out=out)
    evap = int(_evap(params, ldrain1d))
    spans.count(lambda: {**build.sweep_occupancy(_load_kernel(), "cloudsc2_nl", entry,
                                                 inputs.pt, evap),
                         "evap": evap})
    cloudsc2_nl.launches += 1
    return Cloudsc2StreamOutputs(*outs)


@spans.spanned("fwd_sweep")
def launch_cloudsc2_fwd_ckpt(
    inputs: Cloudsc2Inputs, pre: KernelPrelude, params: Params, *,
    ldrain1d: bool = False, out=None,
) -> Tuple[Cloudsc2StreamOutputs, Checkpoints]:
    """Launch the checkpointing forward kernel on CUDA tensors, on the
    current stream: ``(outputs, checkpoints)`` like the plain version.

    Checks device, dtype, shape and contiguity (pqs included), allocates
    the 8 + 3 outputs but those ``out`` gives by name, and raises if the
    launch is refused.  Counts each launch in
    ``cloudsc2_fwd_ckpt.launches``.
    """
    if inputs.pqs is None:
        raise ValueError("the checkpointing forward sweep reads pqs")
    outs = _launch("cloudsc2_fwd_ckpt", FWD_CKPT_STREAMS, FWD_CKPT_OUTPUTS,
                   inputs, pre, params, ldrain1d, out=out)
    cloudsc2_fwd_ckpt.launches += 1
    return Cloudsc2StreamOutputs(*outs[:8]), tuple(outs[8:])


def cloudsc2_nl(
    inputs: Cloudsc2Inputs, params: Params, *, ldrain1d: bool = False,
    out=None,
) -> Cloudsc2StreamOutputs:
    """The fused SATUR+CLOUDSC2 sweep on levels-major inputs.

    CUDA tensors run the hand-written kernel (:func:`launch_cloudsc2_nl`,
    after :func:`kernel_prelude`); CPU tensors run the plain version
    :func:`cloudsc2_nl_reference`; any other device raises.  Both write the
    outputs ``out`` gives by name into those tensors (:func:`flux_slots`).
    """
    device = inputs.pt.device
    if device.type == "cpu":
        return cloudsc2_nl_reference(inputs, params, ldrain1d=ldrain1d, out=out)
    if device.type != "cuda":
        raise ValueError(f"cloudsc2_nl runs on cuda or cpu tensors, not {device}")
    return launch_cloudsc2_nl(inputs, kernel_prelude(inputs, params), params,
                              ldrain1d=ldrain1d, out=out)


def cloudsc2_fwd_ckpt(
    inputs: Cloudsc2Inputs, params: Params, *, ldrain1d: bool = False,
    out=None,
) -> Tuple[Cloudsc2StreamOutputs, Checkpoints]:
    """The checkpointing forward sweep on levels-major inputs with pqs:
    ``(outputs, checkpoints)``.

    CUDA tensors run the hand-written kernel
    (:func:`launch_cloudsc2_fwd_ckpt`, after :func:`kernel_prelude`); CPU
    tensors run the plain version :func:`cloudsc2_fwd_ckpt_reference`; any
    other device raises.  ``out`` as for :func:`cloudsc2_nl`.
    """
    device = inputs.pt.device
    kw = dict(ldrain1d=ldrain1d, out=out)
    if device.type == "cpu":
        return cloudsc2_fwd_ckpt_reference(inputs, params, **kw)
    if device.type != "cuda":
        raise ValueError(f"cloudsc2_fwd_ckpt runs on cuda or cpu tensors, not {device}")
    return launch_cloudsc2_fwd_ckpt(inputs, kernel_prelude(inputs, params),
                                    params, **kw)


cloudsc2_nl.launches = 0
cloudsc2_fwd_ckpt.launches = 0


class FluxRows(NamedTuple):
    """The contract's two flux fields, levels-major ``(nlev+1, ncol)``,
    allocated before the sweep that writes their rows 1.. (:func:`flux_rows`,
    :func:`flux_slots`); the assembly writes their top rows."""

    pfplsl: torch.Tensor
    pfplsn: torch.Tensor


def flux_rows(like: torch.Tensor) -> FluxRows:
    """Two new ``(nlev+1, ncol)`` flux fields for the ``(nlev, ncol)``
    streams ``like``."""
    nlev, ncol = like.shape
    return FluxRows(*(like.new_empty((nlev + 1, ncol)) for _ in FluxRows._fields))


def flux_slots(flux: FluxRows, prefix: str = "") -> dict:
    """The sweeps' ``out`` for the flux streams: rows 1.. of ``flux`` as
    ``<prefix>rfln`` and ``<prefix>sfln`` (``d_`` for a TL sweep's
    tangents)."""
    return {prefix + "rfln": flux.pfplsl[1:], prefix + "sfln": flux.pfplsn[1:]}


def contract_bytes(nlev: int, ncol: int, itemsize: int, *, in_place: bool,
                   seeds: bool, kernel: bool) -> int:
    """Bytes the contract's assembly reads and writes: ``kernel`` the one
    launch of ``csrc/cloudsc2_contract.cu`` (the flux rows read once; the
    enthalpy fluxes written, and the top rows in place or the whole flux
    fields as a copy; the seeds written), else the passes of
    :func:`plain_contract`, each reading its operands and writing its
    result."""
    if kernel:
        rows = 2 * nlev + 2 * (nlev + 1) + (2 if in_place else 2 * (nlev + 1))
        rows += 2 * nlev if seeds else 0
    else:
        # the zero row(s), cat, neg and mul; mul and sub for each seed
        rows = 2 + 8 * (nlev + 1) if in_place else 1 + 12 * (nlev + 1)
        rows += 10 * nlev if seeds else 0
    return rows * ncol * itemsize


def _contract(out: Cloudsc2StreamOutputs, pfplsl, pfplsn, pfhpsl, pfhpsn):
    return Cloudsc2Outputs(
        tenl_t=out.tenl_t, tenl_q=out.tenl_q, tenl_l=out.tenl_l, tenl_i=out.tenl_i,
        pclc=out.pclc, pfplsl=pfplsl, pfplsn=pfplsn, pfhpsl=pfhpsl, pfhpsn=pfhpsn,
        pcovptot=out.pcovptot)


def flux_seeds(d: Cloudsc2Outputs, params: Params):
    """The rain and snow seed streams of the reverse sweep for the
    cotangent ``d`` on the levels-major contract: the flux rows k+1 and the
    enthalpy fluxes (pfhpsl = -rlvtt·pfplsl, cloudsc2.F90:730-735) seed the
    level-k rain and snow outputs, ``pfplsl[1:] - rlvtt·pfhpsl[1:]`` and
    ``pfplsn[1:] - rlstt·pfhpsn[1:]`` (pfplsl[0] is the constant zero top
    row, its cotangent drops).  The one definition of the fold, which
    ``csrc/cloudsc2_contract.cu`` computes bit for bit."""
    cst = params.yomcst
    return (d.pfplsl[1:] - cst.rlvtt * d.pfhpsl[1:],
            d.pfplsn[1:] - cst.rlstt * d.pfhpsn[1:])


def plain_contract(out: Cloudsc2StreamOutputs, params: Params, *,
                   flux: "FluxRows | None" = None, seeds: bool = False):
    """The contract's assembly by PyTorch's own expressions, on any device:
    ``(outputs, seed streams)``, the levels-major :class:`Cloudsc2Outputs`
    (flux top row + enthalpy fluxes, cloudsc2.F90:694-735) and, with
    ``seeds``, the rain and snow seed streams of the reverse sweep for the
    TL image ``out`` (:func:`flux_seeds` of the assembled tangent), else
    ``None``.

    Without ``flux`` the flux fields are new tensors (a zero row and
    ``torch.cat``); with it ``out.rfln``/``sfln`` are its rows 1.. and its top
    rows are zeroed in place.  The plain versions' assembly, and what the
    kernel's is held to bit for bit.  Linear, so it assembles tangents too."""
    cst = params.yomcst
    if flux is None:
        top = torch.zeros_like(out.rfln[:1])
        pfplsl = torch.cat([top, out.rfln], dim=0)
        pfplsn = torch.cat([top, out.sfln], dim=0)
    else:
        pfplsl, pfplsn = flux
        pfplsl[0] = 0.0
        pfplsn[0] = 0.0
    res = _contract(out, pfplsl, pfplsn, -pfplsl * cst.rlvtt, -pfplsn * cst.rlstt)
    return res, (flux_seeds(res, params) if seeds else None)


_CONTRACT_ARGTYPES = [ctypes.POINTER(ctypes.c_void_p)] * 4 + [  # src, flux, enth, seed
    ctypes.c_double, ctypes.c_double,  # rlvtt, rlstt
    ctypes.c_int, ctypes.c_int,  # ncol, nlev
    ctypes.c_void_p,  # stream
]


def _load_contract_kernel():
    return build.bind(
        "cloudsc2_contract", {"cloudsc2_contract_abi": (2, 2, 2, 2)},
        {"cloudsc2_contract_f32": _CONTRACT_ARGTYPES,
         "cloudsc2_contract_f64": _CONTRACT_ARGTYPES})


def _launch_contract(out: Cloudsc2StreamOutputs, params: Params,
                     flux: "FluxRows | None", seeds: bool):
    """``csrc/cloudsc2_contract.cu`` on the current stream:
    :func:`plain_contract`'s results, in place where ``flux`` holds the
    sweep's rows, else as a copy into new flux fields.  Raises for dtypes
    other than float32 and float64 and if the launch is refused."""
    src = (out.rfln, out.sfln)
    if src[0].dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the contract's kernel takes float32 or float64 flux "
                        f"streams, not {src[0].dtype}")
    if flux is None:
        src = tuple(x.contiguous() for x in src)
        flux = flux_rows(src[0])
    enth = tuple(torch.empty_like(x) for x in flux)
    seed = tuple(torch.empty_like(x) for x in src) if seeds else (None, None)
    nlev, ncol = src[0].shape
    cst = params.yomcst
    build.launch(_load_contract_kernel(), "cloudsc2_contract", src[0], src, flux,
                 enth, seed, float(cst.rlvtt), float(cst.rlstt), ncol, nlev)
    return _contract(out, *flux, *enth), (seed if seeds else None)


@spans.spanned("contract")
def assemble_contract(out: Cloudsc2StreamOutputs, params: Params, *,
                      flux: "FluxRows | None" = None, seeds: bool = False):
    """Raw streams -> the levels-major :class:`Cloudsc2Outputs` contract,
    and with ``seeds`` the rain and snow seed streams of the reverse sweep
    for a TL image: ``(outputs, seeds | None)``, as :func:`plain_contract`.

    ``flux`` is given where the caller owned the sweep's flux allocation
    (:func:`flux_rows`, :func:`flux_slots`): ``out.rfln``/``sfln`` must be
    its rows 1.., and the flux fields are finished in place.  Without it the
    streams are finished as a copy.  CUDA tensors take one launch of
    ``csrc/cloudsc2_contract.cu`` for either form (counted in
    ``assemble_contract.launches``); CPU tensors take
    :func:`plain_contract`; both give the same bits.  The ``contract`` span
    carries ``in_place`` (1 or 0) and ``bytes`` (:func:`contract_bytes`)."""
    in_place = flux is not None
    if in_place and not all(
            x.shape[0] + 1 == f.shape[0] and x.data_ptr() == f[1].data_ptr()
            for x, f in zip((out.rfln, out.sfln), flux)):
        raise ValueError("the flux streams must be rows 1.. of the flux fields "
                         "given: the sweep writes them there (flux_slots)")
    kernel = out.rfln.is_cuda
    if kernel:
        res, sd = _launch_contract(out, params, flux, seeds)
        assemble_contract.launches += 1
    else:
        res, sd = plain_contract(out, params, flux=flux, seeds=seeds)
    nlev, ncol = out.rfln.shape
    spans.count(lambda: {"in_place": int(in_place), "bytes": contract_bytes(
        nlev, ncol, out.rfln.element_size(), in_place=in_place, seeds=seeds,
        kernel=kernel)})
    return res, sd


assemble_contract.launches = 0


def unblock_outputs(out: Cloudsc2StreamOutputs, params: Params,
                    levels_major: bool = False, *,
                    flux: "FluxRows | None" = None) -> Cloudsc2Outputs:
    """Raw streams -> the :class:`Cloudsc2Outputs` contract (flux top row +
    enthalpy fluxes, cloudsc2.F90:694-735), as ``(ncol, nlev[+1])`` views
    of levels-major tensors, or those tensors themselves with
    ``levels_major``; :func:`assemble_contract`, in place with ``flux``.
    Linear, so it assembles tangents too."""
    res, _ = assemble_contract(out, params, flux=flux)
    return res if levels_major else Cloudsc2Outputs(*(x.T for x in res))
