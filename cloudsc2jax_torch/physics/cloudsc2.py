"""CLOUDSC2 interface: inputs, outputs, fixed tunables, critical humidity.

PyTorch port of the interface part of :mod:`cloudsc2jax.physics.cloudsc2`
(``:43-126``).  The level body itself lives with the kernel that runs it,
:func:`cloudsc2jax_torch.kernels.cloudsc2_kernel.level_physics`.

Field shapes follow the caller: the JAX contract is ``(ncol, nlev)``
(``paph`` and the fluxes ``(ncol, nlev+1)``); the port's kernel path keeps
the levels-major ``(nlev, ncol)`` layout from generation to validation and
hands out ``(ncol, nlev)`` views at its public functions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["Cloudsc2Inputs", "Cloudsc2Outputs"]

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
