"""Saturation adjustment (Newton iteration on the saturation curve).

PyTorch port of :mod:`cloudsc2jax.physics.cuadjtqs` (reference
``src/cloudsc2_nl/cuadjtqs.F90``, KCALL branches at :212/:132/:172/:246).
Two Newton iterations adjust (T, q) onto the saturation curve; the
liquid-vs-ice constant set is chosen *once* from the initial temperature
(cuadjtqs.F90:118-130) and reused for both iterations.

The function is written once; the reference's hand-coded TL
(cuadjtqstl.F90) and AD (cuadjtqsad.F90) are ``torch.func.jvp`` /
``torch.func.vjp`` of it.  Max and min are
:func:`~cloudsc2jax_torch.ops.maximum` / ``minimum``, whose derivative at
a tie is JAX's.
"""

from __future__ import annotations

import torch

from ..constants import Params
from ..ops import maximum, minimum

__all__ = ["cuadjtqs", "cuadjtqs_tl", "cuadjtqs_ad"]

_ZQMAX = 0.5


def _newton_step(t, q, zqp, z3es, z4es, z5alcp, params: Params):
    cst, thf = params.yomcst, params.yoethf
    foeew = thf.r2es * torch.exp(z3es * (t - cst.rtt) / (t - z4es))
    qsat = zqp * foeew
    qsat = torch.where(qsat > _ZQMAX, torch.full_like(qsat, _ZQMAX), qsat)
    cor = 1.0 / (1.0 - cst.retv * qsat)
    qsat = qsat * cor
    z2s = z5alcp / (t - z4es) ** 2
    return (q - qsat) / (1.0 + qsat * cor * z2s)


def cuadjtqs(psp, t, q, params: Params, *, kcall: int = 0):
    """Adjust (t, q) to saturation at pressure ``psp``.

    ``kcall`` semantics follow the reference:
      - 0: unconstrained adjustment (cuadjtqs.F90:212-244), the variant
        inlined in the CLOUDSC2 NL kernel (cloudsc2.F90:628-669);
      - 1: condensation only, first increment clamped >= 0 (:132-170);
      - 2: evaporation only, first increment clamped <= 0 (:172-210);
      - 4: like 0 (:246-278).

    Any other value behaves as 0.  Returns the adjusted ``(t, q)``.
    """
    cst, thf = params.yomcst, params.yoethf
    liquid = t > cst.rtt

    def sel(a, b):
        return torch.where(liquid, torch.full_like(t, a), torch.full_like(t, b))

    z3es = sel(thf.r3les, thf.r3ies)
    z4es = sel(thf.r4les, thf.r4ies)
    z5alcp = sel(thf.r5alvcp, thf.r5alscp)
    zaldcp = sel(thf.ralvdcp, thf.ralsdcp)
    zqp = 1.0 / psp

    cond = _newton_step(t, q, zqp, z3es, z4es, z5alcp, params)
    if kcall == 1:
        cond = maximum(cond, torch.zeros_like(cond))
    elif kcall == 2:
        cond = minimum(cond, torch.zeros_like(cond))
    t = t + zaldcp * cond
    q = q - cond

    cond1 = _newton_step(t, q, zqp, z3es, z4es, z5alcp, params)
    if kcall in (1, 2):
        # second increment suppressed where the first was clamped away
        # (cuadjtqs.F90:165, :205)
        cond1 = torch.where(cond == 0.0, torch.zeros_like(cond1), cond1)
    t = t + zaldcp * cond1
    q = q - cond1
    return t, q


def cuadjtqs_tl(psp, t, q, d_psp, d_t, d_q, params: Params, *, kcall: int = 0):
    """Tangent-linear saturation adjustment (CUADJTQSTL,
    src/cloudsc2_tl/cuadjtqstl.F90:10-14: trajectory PSP5/PT5/PQ5 and
    increments), ``torch.func.jvp`` of :func:`cuadjtqs`.  Returns ``((t,
    q), (d_t, d_q))``."""
    def f(p, tt, qq):
        return cuadjtqs(p, tt, qq, params, kcall=kcall)

    return torch.func.jvp(f, (psp, t, q), (d_psp, d_t, d_q))


def cuadjtqs_ad(psp, t, q, a_t, a_q, params: Params, *, kcall: int = 0):
    """Adjoint saturation adjustment (CUADJTQSAD,
    src/cloudsc2_ad/cuadjtqsad.F90: the trajectory recomputed, then
    reversed), ``torch.func.vjp`` of :func:`cuadjtqs` seeded with the output
    adjoints ``(a_t, a_q)``.  Returns ``((t, q), (a_psp, a_t_in,
    a_q_in))``."""
    def f(p, tt, qq):
        return cuadjtqs(p, tt, qq, params, kcall=kcall)

    out, vjp_fn = torch.func.vjp(f, psp, t, q)
    return out, vjp_fn((a_t, a_q))
