"""CLOUDSC2: inputs, outputs, fixed tunables, and the truth path.

PyTorch port of :mod:`cloudsc2jax.physics.cloudsc2`.  :func:`cloudsc2` is
the nonlinear scheme over a batch of columns as an eager loop over levels
on ``(ncol,)`` tensors, statement for statement the JAX ``lax.scan`` body:
the single source that :mod:`cloudsc2jax_torch.tlad` differentiates with
``torch.func.jvp``/``vjp`` for the f64 Taylor and adjoint tests.  The
kernels' level body is a separate port
(:func:`cloudsc2jax_torch.kernels.cloudsc2_kernel.level_physics`, of the
Pallas ``_level_physics``); the tests hold the two together.

Field shapes follow the caller: the JAX contract is ``(ncol, nlev)``
(``paph`` and the fluxes ``(ncol, nlev+1)``); the port's kernel path keeps
the levels-major ``(nlev, ncol)`` layout from generation to validation and
hands out ``(ncol, nlev)`` views at its public functions.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import torch

from ..constants import Params
from ..ops import damp_tangent, maximum, minimum

__all__ = ["Cloudsc2Inputs", "Cloudsc2Outputs", "cloudsc2"]

# Tunables fixed inside the reference kernel (cloudsc2.F90:172, 242-244).
_ZSCAL = 0.9
_ZQMAX = 0.5
_ZEPS1 = 1.0e-12
_ZEPS2 = 1.0e-10


class Cloudsc2Inputs(NamedTuple):
    """The 16 differentiated inputs, in the order the TL/AD drivers perturb
    them (cloudsc_driver_tl_mod.F90:156-171).  The NL sweep computes qsat
    itself, so its device inputs leave ``pqs`` as ``None``."""

    paph: torch.Tensor  # half-level pressure        [PAPHP1]
    pap: torch.Tensor  # full-level pressure         [PAPP1]
    pq: torch.Tensor  # specific humidity            [PQM1]
    pqs: Optional[torch.Tensor]  # saturation humidity [PQS]
    pt: torch.Tensor  # temperature                  [PTM1]
    pl: torch.Tensor  # cloud liquid water           [PL]
    pi: torch.Tensor  # cloud ice                    [PI]
    plude: torch.Tensor  # detrained liquid          [PLUDE]
    plu: torch.Tensor  # updraught condensate        [PLU]
    pmfu: torch.Tensor  # updraught mass flux        [PMFU]
    pmfd: torch.Tensor  # downdraught mass flux      [PMFD]
    ten_t: torch.Tensor  # accumulated T tendency    [PGTENT]
    ten_q: torch.Tensor  # accumulated q tendency    [PGTENQ]
    ten_l: torch.Tensor  # accumulated ql tendency   [PGTENL]
    ten_i: torch.Tensor  # accumulated qi tendency   [PGTENI]
    psupsat: torch.Tensor  # supersaturation moisture [PSUPSAT]


class Cloudsc2Outputs(NamedTuple):
    """The 10 validated/tested outputs (cloudsc_driver_tl_mod.F90:235-244)."""

    tenl_t: torch.Tensor  # process T tendency       [PTENT]
    tenl_q: torch.Tensor  # process q tendency       [PTENQ]
    tenl_l: torch.Tensor  # process ql tendency      [PTENL]
    tenl_i: torch.Tensor  # process qi tendency      [PTENI]
    pclc: torch.Tensor  # layer cloud cover          [PCLC]
    pfplsl: torch.Tensor  # rain flux (nlev+1)       [PFPLSL]
    pfplsn: torch.Tensor  # snow flux (nlev+1)       [PFPLSN]
    pfhpsl: torch.Tensor  # rain enthalpy flux       [PFHPSL]
    pfhpsn: torch.Tensor  # snow enthalpy flux       [PFHPSN]
    pcovptot: torch.Tensor  # precipitation fraction [PCOVPTOT]


def _crit_rel_humidity(ceta_k, zeta3):
    """Critical relative humidity profile (cloudsc2.F90:384-399)."""
    zrh1 = 1.0
    zrh2 = (
        0.35
        + 0.14 * ((zeta3 - 0.25) / 0.15) ** 2
        + 0.04 * torch.clamp_max(zeta3 - 0.25, 0.0) / 0.15
    )
    zrh3 = 1.0
    zdeta2 = 0.3
    zdeta1 = 0.09 + 0.16 * (0.4 - zeta3) / 0.3
    blend_lo = zrh3 + (zrh2 - zrh3) * ((ceta_k - zeta3) / zdeta2)
    blend_hi = zrh1 + (zrh2 - zrh1) * torch.sqrt(
        torch.clamp_min((1.0 - ceta_k) / zdeta1, 0.0)
    )
    return torch.where(
        ceta_k < zeta3,
        zrh3,
        torch.where(
            ceta_k < zeta3 + zdeta2,
            blend_lo,
            torch.where(ceta_k < 1.0 - zdeta1, zrh2, blend_hi),
        ),
    )


def _tropopause_eta(ztp1, ceta):
    """Eta of the tropopause (cloudsc2.F90:314-326), ``ztp1`` ``(ncol,
    nlev)``.  The deepest level in the 0.1<eta<0.4 band with a temperature
    inversion wins: a masked max.  The result is piecewise constant in the
    inputs (``ceta`` is a constant and the mask is boolean), so it carries
    no tangent, like the reference TL/AD which recompute it from the
    trajectory."""
    mask = (ceta[:-1] > 0.1) & (ceta[:-1] < 0.4) & (ztp1[:, :-1] > ztp1[:, 1:])
    cand = torch.where(mask, ceta[:-1].detach()[None, :], 0.1)
    return cand.amax(dim=-1)


class _LevelCheckpoint(torch.autograd.Function):
    """``jax.checkpoint`` of one level: ``apply(body, *tensors)`` returns
    ``body(*tensors)``, a tuple of tensors, without keeping the body's
    intermediates.  Reverse mode saves only ``tensors`` and recomputes the
    level under ``torch.func.vjp``; forward mode runs ``torch.func.jvp`` of
    the body.  ``torch.utils.checkpoint`` does not compose with
    ``torch.func.vjp``; this does, and nests ``damp_tangent`` inside the
    recomputation.  ``body`` must read no tensor that depends on the inputs
    other than its arguments: a captured one would lose its cotangent."""

    @staticmethod
    def forward(body, *tensors):
        return body(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        body, *tensors = inputs
        ctx.body = body
        ctx.save_for_backward(*tensors)
        ctx.save_for_forward(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        tensors = ctx.saved_tensors
        out, vjp_fn = torch.func.vjp(ctx.body, *tensors)
        grads = tuple(torch.zeros_like(o) if g is None else g
                      for o, g in zip(out, grads))
        return (None, *vjp_fn(grads))

    @staticmethod
    def jvp(ctx, _, *tangents):
        tensors = ctx.saved_tensors
        tangents = tuple(torch.zeros_like(x) if t is None else t
                         for x, t in zip(tensors, tangents))
        return torch.func.jvp(ctx.body, tensors, tangents)[1]


def cloudsc2(
    inputs: Cloudsc2Inputs,
    params: Params,
    *,
    lregcl: bool = False,
    ldrain1d: bool = False,
    remat_level: bool = False,
) -> Cloudsc2Outputs:
    """Nonlinear CLOUDSC2 over a batch of columns, ``(ncol, nlev)`` fields
    (``paph`` ``(ncol, nlev+1)``), on the inputs' device and in their dtype.

    ``lregcl`` activates the TL/AD perturbation regularisations (identity
    on this trajectory; they rescale tangents and cotangents under
    ``torch.func.jvp``/``vjp``, matching YRNCL%LREGCL).  ``ldrain1d``
    mirrors the LDRAIN1D argument.  Both settings of
    ``params.yrephli.lphylin`` are implemented.

    Every data-dependent branch is a select, with the safe-where pattern
    (clamp, then select) wherever the unselected branch could form a NaN or
    an infinite derivative: ``torch.where`` leaks those into gradients as
    ``jnp.where`` does.  Max and min are :func:`~cloudsc2jax_torch.ops.maximum`
    / ``minimum``, whose derivative at a tie is JAX's.

    ``remat_level`` checkpoints the level body (``jax.checkpoint(level_step)``,
    ``cloudsc2jax/physics/cloudsc2.py:465``): reverse mode then stores only
    each level's inputs and carry and recomputes the level
    (:class:`_LevelCheckpoint`).  The values are the same either way.
    """
    cst, thf = params.yomcst, params.yoethf
    cldp, phli, phnc = params.yrecldp, params.yrephli, params.yophnc
    ptsphy = params.ptsphy

    (paph, pap, pq, pqs, pt, pl, pi, plude, plu, pmfu, pmfd,
     ten_t, ten_q, ten_l, ten_i, psupsat) = inputs

    ncol, nlev = pt.shape
    ceta = torch.tensor(params.ceta, dtype=pt.dtype, device=pt.device)

    reg = damp_tangent if lregcl else (lambda x, factor: x)

    # -- 1.1 derived constants (cloudsc2.F90:235-244)
    zckcodtl = 2.0 * cldp.rkconv * ptsphy
    zckcodti = 5.0 * cldp.rkconv * ptsphy
    zcons2 = 1.0 / (ptsphy * cst.rg)
    zcons3 = cst.rlvtt / cst.rcpd
    zmeltp2 = cst.rtt + 2.0
    zqtmst = 1.0 / ptsphy

    # -- 2.1 first-guess state (cloudsc2.F90:253-260)
    ztp1 = pt + ptsphy * ten_t
    zqp1 = pq + ptsphy * ten_q + psupsat
    zl = pl + ptsphy * ten_l
    zi = pi + ptsphy * ten_i

    # level-constant cloud-formation parameter (cloudsc2.F90:266)
    zscalm = _ZSCAL * torch.clamp_min(ceta - 0.2, _ZEPS1) ** 0.2

    # thermodynamic factors (cloudsc2.F90:272-277)
    zdp = paph[:, 1:] - paph[:, :-1]
    zzz = 1.0 / (cst.rcpd + cst.rcpd * thf.rvtmp2 * zqp1)
    zlfdcp = cst.rlmlt * zzz
    zlsdcp = cst.rlstt * zzz
    zlvdcp = cst.rlvtt * zzz

    # tropopause eta (cloudsc2.F90:314-326)
    ztrpaus = _tropopause_eta(ztp1, ceta)

    paph_sfc = paph[:, nlev]  # surface pressure, used by precip evaporation

    levapls2 = bool(phnc.levapls2)
    lphylin = bool(phli.lphylin)

    def level_step(zrfl, zsfl, zcovptot,
                   ztp1_k, zqp1_k, zl_k, zi_k, pap_k, pqs_k, plude_k,
                   plu_k1, pmfu_k, pmfd_k, zdp_k, zlfdcp_k, zlsdcp_k, zlvdcp_k,
                   ztrpaus, paph_sfc, *, ceta_k, zscalm_k, not_last):
        """One level: the carry, the level's 14 inputs and the two
        column-wide inputs in; the new carry and the level's 6 outputs out.
        Every tensor it reads is an argument (the constants ``ceta_k`` and
        ``zscalm_k`` aside), so that :class:`_LevelCheckpoint` sees every
        path from the inputs."""
        one = torch.ones_like(ztp1_k)

        def const(v: float):
            return torch.full_like(one, v)

        def sel(cond, a, b):
            """where(cond, a, b) for two params, in the working dtype."""
            return torch.where(cond, one * a, one * b)

        # ---- 3.1 dqs/dT correction factor (cloudsc2.F90:343-408)
        if lphylin or ldrain1d:
            zoealfaw = 0.545 * (torch.tanh(0.17 * (ztp1_k - phli.rlptrc)) + 1.0)
            cold = ztp1_k < cst.rtt
            zfwat = torch.where(cold, zoealfaw, one)
            z3es = sel(cold, thf.r3ies, thf.r3les)
            z4es = sel(cold, thf.r4ies, thf.r4les)
            zfoeew = thf.r2es * torch.exp(z3es * (ztp1_k - cst.rtt) / (ztp1_k - z4es))
            zesdp = zfoeew / pap_k
            zesdp = torch.where(zesdp > _ZQMAX, const(_ZQMAX), zesdp)
        else:
            alfa = minimum(
                one,
                ((maximum(const(thf.rtice), minimum(const(thf.rtwat), ztp1_k))
                  - thf.rtice) * thf.rtwat_rtice_r) ** 2,
            )
            zfwat = alfa
            ew = torch.exp(thf.r3les * (ztp1_k - cst.rtt) / (ztp1_k - thf.r4les))
            ei = torch.exp(thf.r3ies * (ztp1_k - cst.rtt) / (ztp1_k - thf.r4ies))
            zfoeew = thf.r2es * (alfa * ew + (1.0 - alfa) * ei)
            zesdp = zfoeew / pap_k
        zfacw = thf.r5les / (ztp1_k - thf.r4les) ** 2
        zfaci = thf.r5ies / (ztp1_k - thf.r4ies) ** 2
        zfac = zfwat * zfacw + (1.0 - zfwat) * zfaci
        zcor = 1.0 / (1.0 - cst.retv * zesdp)
        zdqsdtemp = zfac * zcor * pqs_k
        zcorqs = 1.0 + zcons3 * zdqsdtemp

        # clipped humidity (cloudsc2.F90:379-380)
        zqlim = torch.where(zqp1_k > pqs_k, pqs_k, zqp1_k)

        # critical humidity and ice supersaturation (cloudsc2.F90:384-407)
        zcrh2 = _crit_rel_humidity(ceta_k, ztrpaus)
        zsupsat_fac = torch.where(ztp1_k < thf.rtice, 1.8 - 3.0e-3 * ztp1_k, one)
        zqsat = pqs_k * zsupsat_fac
        zqcrit = zcrh2 * zqsat

        # ---- Letreut & Li uniform-PDF cloud cover (cloudsc2.F90:412-427)
        zqt = zqp1_k + zl_k + zi_k
        zqpd = zqsat - zqt
        zqcd = zqsat - zqcrit
        mid = (zqt > zqcrit) & (zqt < zqsat)
        denom = zqcd - zscalm_k * (zqt - zqcrit)
        denom_safe = torch.where(mid, denom, one)
        # arg-safe select: sqrt'(0)=inf would form 0*inf=NaN in reverse
        # mode at inactive points if the argument could reach 0
        ratio = torch.where(mid, zqpd, denom_safe) / denom_safe
        sqrt_ratio = torch.sqrt(maximum(ratio, const(0.0)))
        pclc_mid = 1.0 - sqrt_ratio
        if lregcl:
            # Regularisation of the cloud-fraction perturbation
            # (cloudsc2tl.F90:574-580): tangent scaled by ZYYY computed
            # from the trajectory.
            zqcd_safe = torch.where(mid, zqcd, one)
            zrat = torch.clamp(zqpd / zqcd_safe, 0.0, 1.0)
            zyyy = minimum(
                const(0.3),
                3.5 * torch.sqrt(zrat * (1.0 - zscalm_k * (1.0 - zrat)) ** 3)
                / (1.0 - zscalm_k),
            )
            pclc_mid = damp_tangent(pclc_mid, zyyy)
        zqc_mid = (zscalm_k * zqpd + (1.0 - zscalm_k) * zqcd) * pclc_mid ** 2
        saturated = zqt >= zqsat
        pclc = torch.where(mid, pclc_mid, torch.where(saturated, one, 0.0))
        zqc = torch.where(
            mid,
            zqc_mid,
            torch.where(saturated, (1.0 - zscalm_k) * zqcd, 0.0),
        )

        # ---- convective detrainment contribution (cloudsc2.F90:431-444)
        zgdp = cst.rg / zdp_k
        zlude = plude_k * ptsphy * zgdp
        llo1 = not_last & (zlude >= cldp.rlmin) & (plu_k1 >= _ZEPS2)
        plu_safe = torch.where(llo1, plu_k1, one)
        pclc_conv = pclc + (1.0 - pclc) * (1.0 - torch.exp(-zlude / plu_safe))
        pclc = torch.where(llo1, pclc_conv, pclc)
        zqc = torch.where(llo1, zqc + zlude, zqc)

        # ---- compensating subsidence (cloudsc2.F90:448-460)
        zrho = pap_k / (cst.rd * ztp1_k)
        zrodqsdp = -zrho * pqs_k / (pap_k - cst.retv * zfoeew)
        zldcp = zfwat * zlvdcp_k + (1.0 - zfwat) * zlsdcp_k
        zfac3 = 1.0 / (1.0 + zldcp * zdqsdtemp)
        dtdzmo = cst.rg * (1.0 / cst.rcpd - zldcp * zrodqsdp) * zfac3
        zdqsdz = zdqsdtemp * dtdzmo - cst.rg * zrodqsdp
        zdqc_sub = zdqsdz * (pmfu_k + pmfd_k) * ptsphy / zrho
        # MIN with the Fortran tie convention (a < qc picks a); under
        # LREGCL the subsidence tangent is damped by 0.1
        # (cloudsc2tl.F90:651-661).
        zdqc = torch.where(zdqc_sub < zqc, reg(zdqc_sub, 0.1), zqc)
        zqc = zqc - zdqc

        # ---- condensation rates (cloudsc2.F90:464-469)
        zqlwc = zqc * zfwat
        zqiwc = zqc * (1.0 - zfwat)
        zcondl = (zqlwc - zl_k) * zqtmst
        zcondi = (zqiwc - zi_k) * zqtmst

        # ---- max-overlap precipitation fraction (cloudsc2.F90:475-481)
        zcovptot = maximum(zcovptot, pclc)
        zcovpclr = maximum(zcovptot - pclc, const(0.0))

        # ---- melting of incoming snow (cloudsc2.F90:487-498)
        # Branchless: ZSFL==0 gives ZSNMLT==0 exactly.
        zcons = zcons2 * zdp_k / zlfdcp_k
        zsnmlt = minimum(zsfl, zcons * maximum(const(0.0), ztp1_k - zmeltp2))
        zrfln = zrfl + zsnmlt
        zsfln = zsfl - zsnmlt
        ztp1_k = ztp1_k - zsnmlt / zcons

        # ---- rain production from cloud liquid (cloudsc2.F90:504-517)
        active = pclc > _ZEPS2
        pclc_safe = torch.where(active, pclc, one)
        zlcrit_l = 1.9 * cldp.rclcrit if (levapls2 or ldrain1d) else 2.0 * cldp.rclcrit
        zcldl = zqlwc / pclc_safe
        zdl = zckcodtl * (1.0 - torch.exp(-((zcldl / zlcrit_l) ** 2)))
        # autoconversion tangent damped by 1/100 via ZCKCODTLA
        # (cloudsc2tl.F90:323, 751-760)
        zdl = reg(zdl, 0.01)
        zlnew = pclc * zcldl * torch.exp(-zdl)
        zprr = torch.where(active, zqlwc - zlnew, 0.0)
        zqlwc = zqlwc - zprr

        # ---- snow production from cloud ice (cloudsc2.F90:521-534)
        zlcrit_i = 1.0e-4 if (levapls2 or ldrain1d) else 2.0 * cldp.rclcrit
        zcldi = zqiwc / pclc_safe
        zdi = (
            zckcodti
            * torch.exp(0.025 * (ztp1_k - cst.rtt))
            * (1.0 - torch.exp(-((zcldi / zlcrit_i) ** 2)))
        )
        zdi = reg(zdi, 0.01)  # (cloudsc2tl.F90:324, 791-800)
        zinew = pclc * zcldi * torch.exp(-zdi)
        zprs = torch.where(active, zqiwc - zinew, 0.0)
        zqiwc = zqiwc - zprs

        # ---- new precipitation & freezing split (cloudsc2.F90:538-552)
        zdr = zcons2 * zdp_k * (zprr + zprs)
        cold = ztp1_k < cst.rtt
        zrfreeze = torch.where(cold, zcons2 * zdp_k * zprr, 0.0)
        zfwatr = torch.where(cold, 0.0, one)
        zrfln = zrfln + zfwatr * zdr
        zsfln = zsfln + (1.0 - zfwatr) * zdr

        # ---- clear-sky precip evaporation (cloudsc2.F90:556-591)
        # Active only under LEVAPLS2 or LDRAIN1D (llo2); PCOVPTOT is written
        # only here (:582).
        zprtot = zrfln + zsfln
        if levapls2 or ldrain1d:
            llo2 = (zprtot > _ZEPS2) & (zcovpclr > _ZEPS2)
            covptot_safe = torch.where(llo2, zcovptot, one)
            covpclr_safe = torch.where(llo2, zcovpclr, one)
            one_m_clc = torch.where(llo2, (1.0 - pclc) ** 2, one)
            zpreclr = zprtot * zcovpclr / covptot_safe
            zqe = pqs_k - (pqs_k - zqlim) * zcovpclr / one_m_clc
            # arg-safe select before the fractional power: x**0.5777 has an
            # infinite derivative at x=0, which would form 0*inf=NaN in
            # reverse mode at inactive points
            zbeta_arg = torch.where(
                llo2,
                torch.sqrt(pap_k / paph_sfc) / 5.09e-3 * zpreclr / covpclr_safe,
                one,
            )
            zbeta = cst.rg * cldp.rpecons * zbeta_arg ** 0.5777
            zb = ptsphy * zbeta * (pqs_k - zqe) / (1.0 + zbeta * ptsphy * zcorqs)
            zdtgdp = ptsphy * cst.rg / zdp_k
            zdpr = minimum(zcovpclr * zb / zdtgdp, zpreclr)
            zpreclr2 = zpreclr - zdpr
            zcovptot_new = torch.where(zpreclr2 <= 0.0, pclc, zcovptot)
            zcovptot = torch.where(llo2, zcovptot_new, zcovptot)
            pcovptot_k = torch.where(llo2, zcovptot, 0.0)
            prtot_safe = torch.where(llo2, zprtot, one)
            zevapr = torch.where(llo2, zdpr * zrfln / prtot_safe, 0.0)
            zevaps = torch.where(llo2, zdpr * zsfln / prtot_safe, 0.0)
            zrfln = zrfln - zevapr
            zsfln = zsfln - zevaps
        else:
            pcovptot_k = torch.zeros_like(zprtot)
            zevapr = torch.zeros_like(zprtot)
            zevaps = torch.zeros_like(zprtot)

        # ---- tendency update + first-guess T/q (cloudsc2.F90:601-618)
        def tendencies(condl, condi, rfreeze):
            dqdt = -(condl + condi) + (plude_k + zevapr + zevaps) * zgdp
            dtdt = (
                zlvdcp_k * condl
                + zlsdcp_k * condi
                - (
                    zlvdcp_k * zevapr
                    + zlsdcp_k * zevaps
                    + plude_k * (zfwat * zlvdcp_k + (1.0 - zfwat) * zlsdcp_k)
                    - (zlsdcp_k - zlvdcp_k) * rfreeze
                )
                * zgdp
            )
            return dqdt, dtdt

        zdqdt, zdtdt = tendencies(zcondl, zcondi, zrfreeze)
        ztp1_k = ztp1_k + ptsphy * zdtdt
        zqp1_k = zqp1_k + ptsphy * zdqdt
        zqold = zqp1_k

        # ---- clipping of final qv: inlined CUADJTQS, 2 Newton iterations
        # (cloudsc2.F90:628-669); phase constants chosen once.
        liquid = ztp1_k > cst.rtt
        z3es = sel(liquid, thf.r3les, thf.r3ies)
        z4es = sel(liquid, thf.r4les, thf.r4ies)
        z5alcp = sel(liquid, thf.r5alvcp, thf.r5alscp)
        zaldcp = sel(liquid, thf.ralvdcp, thf.ralsdcp)
        zqp = 1.0 / pap_k
        for _ in range(2):
            zfoeew_a = thf.r2es * torch.exp(
                z3es * (ztp1_k - cst.rtt) / (ztp1_k - z4es)
            )
            zqsat_a = zqp * zfoeew_a
            zqsat_a = torch.where(zqsat_a > _ZQMAX, const(_ZQMAX), zqsat_a)
            zcor_a = 1.0 / (1.0 - cst.retv * zqsat_a)
            zqsat_a = zqsat_a * zcor_a
            z2s = z5alcp / (ztp1_k - z4es) ** 2
            zcond1 = (zqp1_k - zqsat_a) / (1.0 + zqsat_a * zcor_a * z2s)
            ztp1_k = ztp1_k + zaldcp * zcond1
            zqp1_k = zqp1_k - zcond1

        # ---- post-adjustment precipitation/freezing (cloudsc2.F90:672-692)
        diff = zqold - zqp1_k
        # clipping tangent damped by 0.7 under LREGCL
        # (cloudsc2tl.F90:994-1001)
        zdq = torch.where(diff >= 0.0, reg(diff, 0.7), torch.zeros_like(diff))
        zdr2 = zcons2 * zdp_k * zdq
        cold2 = ztp1_k < cst.rtt
        zrfreeze2 = torch.where(cold2, zfwat * zdr2, 0.0)
        zfwatr = torch.where(cold2, 0.0, one)
        zcondl = zcondl + zfwatr * zdq * zqtmst
        zcondi = zcondi + (1.0 - zfwatr) * zdq * zqtmst
        zrfln = zrfln + zfwatr * zdr2
        zsfln = zsfln + (1.0 - zfwatr) * zdr2
        zrfreeze = zrfreeze + zrfreeze2

        # ---- outputs (cloudsc2.F90:694-716)
        zdqdt, zdtdt = tendencies(zcondl, zcondi, zrfreeze)
        tenl_l = (zqlwc - zl_k) * zqtmst
        tenl_i = (zqiwc - zi_k) * zqtmst

        return (zrfln, zsfln, zcovptot,
                zdtdt, zdqdt, tenl_l, tenl_i, pclc, pcovptot_k)

    # the level loop (the reference's lax.scan); plu(k+1) is zero below the
    # last level, where not_last masks it
    zero = torch.zeros_like(pt[:, 0])
    carry = (zero, zero, zero)
    ys = []
    for k in range(nlev):
        step = partial(level_step, ceta_k=ceta[k], zscalm_k=zscalm[k],
                       not_last=k < nlev - 1)
        args = (
            *carry,
            ztp1[:, k], zqp1[:, k], zl[:, k], zi[:, k], pap[:, k], pqs[:, k],
            plude[:, k], plu[:, k + 1] if k + 1 < nlev else zero,
            pmfu[:, k], pmfd[:, k], zdp[:, k], zlfdcp[:, k], zlsdcp[:, k],
            zlvdcp[:, k], ztrpaus, paph_sfc,
        )
        out = _LevelCheckpoint.apply(step, *args) if remat_level else step(*args)
        carry = out[:3]
        ys.append((*out[3:], out[0], out[1]))
    (tent, tenq, tenl, teni, pclc, pcovptot, rfln, sfln) = (
        torch.stack(f, dim=1) for f in zip(*ys))

    top = torch.zeros_like(rfln[:, :1])
    pfplsl = torch.cat([top, rfln], dim=1)
    pfplsn = torch.cat([top, sfln], dim=1)

    # enthalpy fluxes (cloudsc2.F90:730-735)
    pfhpsl = -pfplsl * cst.rlvtt
    pfhpsn = -pfplsn * cst.rlstt

    return Cloudsc2Outputs(
        tenl_t=tent,
        tenl_q=tenq,
        tenl_l=tenl,
        tenl_i=teni,
        pclc=pclc,
        pfplsl=pfplsl,
        pfplsn=pfplsn,
        pfhpsl=pfhpsl,
        pfhpsn=pfhpsn,
        pcovptot=pcovptot,
    )
