"""Thermodynamical saturation functions.

PyTorch port of :mod:`cloudsc2jax.thermo`: the statement functions of the
reference include ``src/common/include/fcttre.func.h`` (module form
``src/common/module/fcttre_mod.F90``) plus FOKOOP from ``fccld.func.h``.
Every function is elementwise over tensors of any shape, computes in the
tensor's dtype and is differentiable; the constants come in explicitly as
the :class:`~cloudsc2jax_torch.constants.Yomcst` /
:class:`~cloudsc2jax_torch.constants.Yoethf` groups.  The phase selects
break their ties at ``t == rtt`` as the JAX package's ``jnp.where`` calls
do.
"""

from __future__ import annotations

import torch

from .constants import Yoethf, Yomcst

__all__ = [
    "foedelta",
    "foeew",
    "foede",
    "foedesu",
    "foelh",
    "foeldcp",
    "foealfa",
    "foeewm",
    "foe_dewm_dt",
    "foedem",
    "foeldcpm",
    "foelhm",
    "foetb",
    "foealfcu",
    "foeewmcu",
    "foedemcu",
    "foeldcpmcu",
    "foelhmcu",
    "foeewmo",
    "foeeliq",
    "foeeice",
    "fokoop",
]


def foedelta(t, cst: Yomcst):
    """1 for water (T>=RTT), 0 for ice (fcttre.func.h:32)."""
    return (t >= cst.rtt).to(t.dtype)


def foeew(t, cst: Yomcst, thf: Yoethf):
    """Saturation vapour pressure, sharp water/ice split (fcttre.func.h:42-44)."""
    d = foedelta(t, cst)
    r3 = thf.r3les * d + thf.r3ies * (1.0 - d)
    r4 = thf.r4les * d + thf.r4ies * (1.0 - d)
    return thf.r2es * torch.exp(r3 * (t - cst.rtt) / (t - r4))


def foede(t, cst: Yomcst, thf: Yoethf):
    """(fcttre.func.h:46-48)."""
    d = foedelta(t, cst)
    r5alcp = d * thf.r5alvcp + (1.0 - d) * thf.r5alscp
    r4 = thf.r4les * d + thf.r4ies * (1.0 - d)
    return r5alcp / (t - r4) ** 2


def foedesu(t, cst: Yomcst, thf: Yoethf):
    """(fcttre.func.h:50-52)."""
    d = foedelta(t, cst)
    r5 = d * thf.r5les + (1.0 - d) * thf.r5ies
    r4 = thf.r4les * d + thf.r4ies * (1.0 - d)
    return r5 / (t - r4) ** 2


def foelh(t, cst: Yomcst, thf: Yoethf):
    d = foedelta(t, cst)
    return d * cst.rlvtt + (1.0 - d) * cst.rlstt


def foeldcp(t, cst: Yomcst, thf: Yoethf):
    d = foedelta(t, cst)
    return d * thf.ralvdcp + (1.0 - d) * thf.ralsdcp


def foealfa(t, thf: Yoethf):
    """Liquid fraction in mixed phase, 0..1 (fcttre.func.h:74-75)."""
    return torch.clamp_max(
        ((torch.clamp(t, min=thf.rtice, max=thf.rtwat) - thf.rtice)
         * thf.rtwat_rtice_r) ** 2,
        1.0,
    )


def _ew_ei(t, cst: Yomcst, thf: Yoethf):
    """exp of the water and of the ice curve, without R2ES."""
    ew = torch.exp(thf.r3les * (t - cst.rtt) / (t - thf.r4les))
    ei = torch.exp(thf.r3ies * (t - cst.rtt) / (t - thf.r4ies))
    return ew, ei


def foeewm(t, cst: Yomcst, thf: Yoethf):
    """Mixed-phase saturation vapour pressure (fcttre.func.h:81-83)."""
    alfa = foealfa(t, thf)
    ew, ei = _ew_ei(t, cst, thf)
    return thf.r2es * (alfa * ew + (1.0 - alfa) * ei)


def foe_dewm_dt(t, cst: Yomcst, thf: Yoethf):
    """d FOEEWM / dT (fcttre.func.h:85-89)."""
    alfa = foealfa(t, thf)
    ew, ei = _ew_ei(t, cst, thf)
    return thf.r2es * (
        thf.r3les * alfa * ew * (cst.rtt - thf.r4les) / (t - thf.r4les) ** 2
        + thf.r3ies * (1.0 - alfa) * ei * (cst.rtt - thf.r4ies) / (t - thf.r4ies) ** 2
    )


def _dem(alfa, t, thf: Yoethf):
    return alfa * thf.r5alvcp / (t - thf.r4les) ** 2 + (1.0 - alfa) * thf.r5alscp / (
        t - thf.r4ies
    ) ** 2


def foedem(t, thf: Yoethf):
    """(fcttre.func.h:91-92)."""
    return _dem(foealfa(t, thf), t, thf)


def foeldcpm(t, thf: Yoethf):
    alfa = foealfa(t, thf)
    return alfa * thf.ralvdcp + (1.0 - alfa) * thf.ralsdcp


def foelhm(t, cst: Yomcst, thf: Yoethf):
    alfa = foealfa(t, thf)
    return alfa * cst.rlvtt + (1.0 - alfa) * cst.rlstt


def foetb(t, cst: Yomcst, thf: Yoethf):
    """(fcttre.func.h:104-105)."""
    alfa = foealfa(t, thf)
    return alfa * thf.r3les * (cst.rtt - thf.r4les) / (t - thf.r4les) ** 2 + (
        1.0 - alfa
    ) * thf.r3ies * (cst.rtt - thf.r4ies) / (t - thf.r4ies) ** 2


def foealfcu(t, thf: Yoethf):
    """Convective mixed-phase liquid fraction (fcttre.func.h:122-123)."""
    return torch.clamp_max(
        ((torch.clamp(t, min=thf.rticecu, max=thf.rtwat) - thf.rticecu)
         * thf.rtwat_rticecu_r) ** 2,
        1.0,
    )


def foeewmcu(t, cst: Yomcst, thf: Yoethf):
    """(fcttre.func.h:129-131)."""
    alfa = foealfcu(t, thf)
    ew, ei = _ew_ei(t, cst, thf)
    return thf.r2es * (alfa * ew + (1.0 - alfa) * ei)


def foedemcu(t, thf: Yoethf):
    return _dem(foealfcu(t, thf), t, thf)


def foeldcpmcu(t, thf: Yoethf):
    alfa = foealfcu(t, thf)
    return alfa * thf.ralvdcp + (1.0 - alfa) * thf.ralsdcp


def foelhmcu(t, cst: Yomcst, thf: Yoethf):
    alfa = foealfcu(t, thf)
    return alfa * cst.rlvtt + (1.0 - alfa) * cst.rlstt


def foeewmo(t, cst: Yomcst, thf: Yoethf):
    """WMO saturation (always w.r.t. water) (fcttre.func.h:153)."""
    return thf.r2es * torch.exp(thf.r3les * (t - cst.rtt) / (t - thf.r4les))


foeeliq = foeewmo


def foeeice(t, cst: Yomcst, thf: Yoethf):
    """Saturation w.r.t. ice (fcttre.func.h:155)."""
    return thf.r2es * torch.exp(thf.r3ies * (t - cst.rtt) / (t - thf.r4ies))


def fokoop(t, cst: Yomcst, thf: Yoethf):
    """Koop homogeneous-nucleation factor (fccld.func.h:17)."""
    return torch.minimum(thf.rkoop1 - thf.rkoop2 * t,
                         foeeliq(t, cst, thf) / foeeice(t, cst, thf))
