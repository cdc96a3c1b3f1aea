"""The fields each contract returns, by name, and the reference's value of
each: what the comparison holds every call it checks to."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .reference.physics import INPUTS, OUTPUTS

TANGENT = "d_"
ADJOINT = "a_"
# the NL sweep's 8 levels-major streams: the standard outputs without the
# zero top flux row and the enthalpy fluxes (cloudsc2.F90:694-735)
STREAMS = ("tenl_t", "tenl_q", "tenl_l", "tenl_i", "pclc", "pcovptot",
           "rfln", "sfln")
# a stream's flux below each level: the standard flux without its top row
_FLUX = {"rfln": "pfplsl", "sfln": "pfplsn"}


def expected(unit: str, contract: str, write_primal: bool = True) -> Tuple[str, ...]:
    """The names of every field one call of ``unit`` on ``contract``
    returns."""
    per = STREAMS if contract == "stream" else OUTPUTS
    if unit == "nl":
        return per
    primal = per if write_primal else ()
    return (*primal, *(TANGENT + n for n in per), *(ADJOINT + n for n in INPUTS))


def reference_fields(ref: Tuple[Dict[str, torch.Tensor], ...],
                     names) -> Dict[str, torch.Tensor]:
    """The reference's ``(ncol, nlev[+1])`` value of each of ``names``;
    ``ref`` is ``(outputs,)`` or ``(outputs, tangents, adjoints)``."""
    groups = {"": ref[0]}
    if len(ref) == 3:
        groups.update({TANGENT: ref[1], ADJOINT: ref[2]})
    res = {}
    for name in names:
        prefix = name[:2] if name[:2] in (TANGENT, ADJOINT) else ""
        base, group = name[len(prefix):], groups[prefix]
        if base in _FLUX and prefix != ADJOINT:
            res[name] = group[_FLUX[base]][:, 1:]
        else:
            res[name] = group[base]
    return res
