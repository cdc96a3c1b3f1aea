"""Thermodynamical saturation functions reached by SATUR.

PyTorch port of the statement functions in
``src/common/include/fcttre.func.h`` that :func:`cloudsc2jax_torch.physics.
satur.satur` calls (the JAX package's :mod:`cloudsc2jax.thermo` carries the
full set).  Every function is elementwise over tensors of any shape and
computes in the tensor's dtype.
"""

from __future__ import annotations

import torch

from .constants import Yoethf, Yomcst

__all__ = ["foealfa", "foeewm", "foeewmcu"]


def foealfa(t, thf: Yoethf):
    """Liquid fraction in mixed phase, 0..1 (fcttre.func.h:74-75)."""
    return torch.clamp_max(
        ((torch.clamp(t, min=thf.rtice, max=thf.rtwat) - thf.rtice)
         * thf.rtwat_rtice_r) ** 2,
        1.0,
    )


def foeewm(t, cst: Yomcst, thf: Yoethf):
    """Mixed-phase saturation vapour pressure (fcttre.func.h:81-83)."""
    alfa = foealfa(t, thf)
    ew = torch.exp(thf.r3les * (t - cst.rtt) / (t - thf.r4les))
    ei = torch.exp(thf.r3ies * (t - cst.rtt) / (t - thf.r4ies))
    return thf.r2es * (alfa * ew + (1.0 - alfa) * ei)


def _foealfcu(t, thf: Yoethf):
    """Convective mixed-phase liquid fraction (fcttre.func.h:122-123)."""
    return torch.clamp_max(
        ((torch.clamp(t, min=thf.rticecu, max=thf.rtwat) - thf.rticecu)
         * thf.rtwat_rticecu_r) ** 2,
        1.0,
    )


def foeewmcu(t, cst: Yomcst, thf: Yoethf):
    """(fcttre.func.h:129-131)."""
    alfa = _foealfcu(t, thf)
    ew = torch.exp(thf.r3les * (t - cst.rtt) / (t - thf.r4les))
    ei = torch.exp(thf.r3ies * (t - cst.rtt) / (t - thf.r4ies))
    return thf.r2es * (alfa * ew + (1.0 - alfa) * ei)
