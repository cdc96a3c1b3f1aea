"""Saturation specific humidity.

PyTorch port of :func:`cloudsc2jax.physics.satur.satur` (reference kernel
``src/cloudsc2_nl/satur.F90``).  Elementwise over tensors of any shape; it
computes in the dtype and on the device of its inputs.
"""

from __future__ import annotations

import torch

from .. import thermo
from ..constants import Params

__all__ = ["satur"]

_ZQMAX = 0.5  # satur.F90:98


def satur(pap, t, params: Params, *, lphylin: bool = True, kflag: int = 2):
    """Saturation specific humidity qsat(T, p).

    Parameters mirror ``SATUR(KIDIA,KFDIA,KLON,KTDIA,KLEV,LDPHYLIN,PAPRSF,
    PT,PQSAT,KFLAG)`` (satur.F90:10-11).

    - ``lphylin=True`` (the drivers' configuration) mixes explicit
      liquid/ice saturation pressures with the FOEALFA liquid fraction
      (satur.F90:106-123).
    - otherwise FOEEWMCU (kflag=1, convection) or FOEEWM is used
      (satur.F90:124-140).
    """
    cst, thf = params.yomcst, params.yoethf
    if lphylin:
        alfa = thermo.foealfa(t, thf)
        ew_liq = thf.r2es * torch.exp(thf.r3les * (t - cst.rtt) / (t - thf.r4les))
        ew_ice = thf.r2es * torch.exp(thf.r3ies * (t - cst.rtt) / (t - thf.r4ies))
        ew = alfa * ew_liq + (1.0 - alfa) * ew_ice
        qs = torch.clamp_max(ew / pap, _ZQMAX)
    else:
        ew = (
            thermo.foeewmcu(t, cst, thf)
            if kflag == 1
            else thermo.foeewm(t, cst, thf)
        )
        qs = torch.clamp_max(ew / pap, _ZQMAX)
    return qs / (1.0 - cst.retv * qs)
