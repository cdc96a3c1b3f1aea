"""The benchmark's inputs: seeded stored columns, tiled on the device.

A frozen copy of the synthetic state of the system's generator (NumPy, with
the reference's own SATUR for the humidity): 100 physically plausible
columns on an IFS-like grid of 137 levels, drawn from a seed.  A cell's
inputs are a pool of such sets, each from its own seed-derived columns,
tiled cyclically to the cell's columns on the device, as the upstream
dwarf's ``expand_mod.F90`` tiles its 100 stored columns.  Every set is
rounded once to the configuration's precision; the system under test and
the reference read the same rounded values.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .reference import physics

# (z_base [m], T_base [K], lapse [K/m]): a piecewise-linear ICAO-like profile
_LAYERS = ((0.0, 288.15, -6.5e-3), (11000.0, 216.65, 0.0),
           (20000.0, 216.65, 1.0e-3), (32000.0, 228.65, 2.8e-3),
           (47000.0, 270.65, 0.0), (51000.0, 270.65, -2.8e-3),
           (71000.0, 214.65, -2.0e-3))

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _standard_t(z):
    t = np.empty_like(z)
    for zb, tb, lr in _LAYERS:
        sel = z >= zb
        t[sel] = tb + lr * (z[sel] - zb)
    t[z < 0] = 288.15
    return t


def stored_columns(seed: int, index: int, *, nlon: int, nlev: int,
                   c) -> Dict[str, np.ndarray]:
    """The 16 inputs of ``nlon`` columns of set ``index`` of ``seed``,
    levels-major float64 ``(nlev, nlon)`` (``paph`` ``(nlev+1, nlon)``),
    without ``pqs`` (:func:`make_sets` adds it).  ``c`` holds the reference's
    constants (:func:`benchmark.reference.physics.consts`)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), int(index)]))

    # half levels refined towards the surface, top at ~80 km
    s = np.linspace(0.0, 1.0, nlev + 1)
    z_half = 80000.0 * (1.0 - s) ** 1.7
    ps = 101325.0 * (1.0 + 0.02 * rng.standard_normal(nlon)).clip(0.94, 1.04)
    t_prof = _standard_t(z_half)
    rd, g = 287.0597, 9.80665
    lnp = np.zeros(nlev + 1)
    for k in range(nlev - 1, -1, -1):
        tbar = 0.5 * (t_prof[k] + t_prof[k + 1])
        lnp[k] = lnp[k + 1] - g * (z_half[k] - z_half[k + 1]) / (rd * tbar)
    paph = ps[None, :] * np.exp(lnp)[:, None]
    pap = 0.5 * (paph[:-1] + paph[1:])
    z_full = 0.5 * (z_half[:-1] + z_half[1:])

    # warm and cold columns, boundary-layer noise
    dt_col = 8.0 * rng.standard_normal(nlon)
    pt = _standard_t(z_full)[:, None] + dt_col[None, :] * np.exp(-z_full[:, None] / 12000.0)
    pt = (pt + 0.8 * rng.standard_normal((nlev, nlon))).clip(180.0, 320.0)

    # humidity: a fraction of saturation, moist below, dry stratosphere
    qs = physics.satur(torch.from_numpy(pap), torch.from_numpy(pt), c).numpy()
    rh = (0.55 + 0.35 * np.exp(-z_full[:, None] / 3000.0)
          + 0.12 * np.sin(z_full[:, None] / 2500.0)
          + 0.18 * rng.standard_normal((1, nlon))
          + 0.06 * rng.standard_normal((nlev, nlon))).clip(0.05, 1.05)
    pfrac = pap / ps[None, :]
    pq = (rh * qs).clip(1e-9, 0.03)
    pq = np.where(pfrac < 0.2, np.minimum(pq, 3.0e-6), pq)

    # condensate: liquid at 600-950 hPa, ice at 200-600 hPa, cloudy columns
    cloudy = (rng.random(nlon) < 0.65).astype(float)
    amp = rng.random(nlon) * cloudy
    liq_band = np.exp(-(((pfrac - 0.8) / 0.12) ** 2))
    ice_band = np.exp(-(((pfrac - 0.4) / 0.15) ** 2))
    ql = 2.5e-4 * liq_band * amp[None, :] * rng.random((nlev, nlon))
    qi = 1.2e-4 * ice_band * amp[None, :] * rng.random((nlev, nlon))

    # convection in ~40% of the columns, below ~300 hPa
    conv = (rng.random(nlon) < 0.4).astype(float)
    band = np.exp(-(((pfrac - 0.65) / 0.25) ** 2)) * np.clip((pfrac - 0.3) / 0.1, 0.0, 1.0)
    plu = 1.5e-4 * band * conv[None, :] * rng.random((nlev, nlon))
    plude = 2.0e-5 * band * conv[None, :] * rng.random((nlev, nlon))
    pmfu = 8.0e-3 * band * conv[None, :] * rng.random((nlev, nlon))
    pmfd = -2.0e-3 * band * conv[None, :] * rng.random((nlev, nlon))

    # tendencies of the other processes, vanishing in the upper atmosphere
    taper = np.clip(pfrac / 0.05, 0.0, 1.0)
    ten_t = 2.0e-5 * rng.standard_normal((nlev, nlon)) * (1.0 + 2.0 * pfrac) * taper
    ten_q = 1.0e-8 * rng.standard_normal((nlev, nlon)) * taper * (pfrac > 0.2)
    ten_l = 2.0e-9 * rng.standard_normal((nlev, nlon)) * (ql > 0)
    ten_i = 1.0e-9 * rng.standard_normal((nlev, nlon)) * (qi > 0)
    psupsat = np.where((pt < 250.0) & (pfrac > 0.2),
                       2.0e-6 * rng.random((nlev, nlon)), 0.0)
    return {"paph": paph, "pap": pap, "pq": pq, "pt": pt, "pl": ql, "pi": qi,
            "plude": plude, "plu": plu, "pmfu": pmfu, "pmfd": pmfd,
            "ten_t": ten_t, "ten_q": ten_q, "ten_l": ten_l, "ten_i": ten_i,
            "psupsat": psupsat}


def make_sets(seed: int, n_sets: int, *, nlon: int, nlev: int, c,
              dtype: torch.dtype, pqs: bool) -> List[Dict[str, torch.Tensor]]:
    """``n_sets`` sets of stored columns on the host, each field rounded to
    ``dtype``, levels-major; with ``pqs`` the saturation humidity of the
    rounded pt and pap, rounded the same way (the TL+AD unit reads it as an
    input)."""
    sets = []
    for i in range(n_sets):
        raw = stored_columns(seed, i, nlon=nlon, nlev=nlev, c=c)
        x = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype)
             for k, v in raw.items()}
        if pqs:
            x["pqs"] = physics.satur(x["pap"].double(), x["pt"].double(), c).to(dtype)
        sets.append({k: x[k] for k in physics.INPUTS if k in x})
    return sets


def ceta(stored: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The eta of each full level, as the dwarf's entry program builds it:
    PAP(1,:)/PAPH(1,KLEV+1) of the first stored column, in float64."""
    pap, paph = stored["pap"].double(), stored["paph"].double()
    return pap[:, 0] / paph[-1, 0]


def tile(stored: Dict[str, torch.Tensor], ncol: int,
         device) -> Dict[str, torch.Tensor]:
    """The stored columns tiled cyclically to ``ncol`` columns on
    ``device``: column i is stored column ``i % nlon``, levels-major."""
    nlon = next(iter(stored.values())).shape[1]
    idx = torch.arange(ncol, device=device) % nlon
    return {k: v.to(device).index_select(1, idx) for k, v in stored.items()}
