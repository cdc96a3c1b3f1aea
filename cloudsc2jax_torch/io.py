"""Input/reference file I/O and synthetic-state generation.

Port of :mod:`cloudsc2jax.io`, which holds no JAX code but cannot be
imported without JAX.  Files keep the reference schema exactly (datasets
stored ``(nlev[, +1], nlon)`` C-order float64, scalars as 1-element
datasets, cloudsc2_array_state_mod.F90:161-199).  A store is an ``.npz``
archive or an ``.h5`` file; ``h5py`` is imported only for the latter, so a
machine without it reads and writes ``.npz`` stores.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .constants import NCLDQI, NCLDQL, NCLV, Params

__all__ = [
    "open_store",
    "h5_to_npz",
    "synthetic_state",
    "expand_columns",
    "load_input_h5",
    "load_reference_h5",
    "write_store",
    "write_input_h5",
    "write_reference_h5",
    "INPUT_FIELDS",
    "REFERENCE_FIELDS",
]

# field name -> per-column trailing shape, as functions of (nlev,)
INPUT_FIELDS = {
    "PT": lambda nlev: (nlev,),
    "PQ": lambda nlev: (nlev,),
    "PAP": lambda nlev: (nlev,),
    "PAPH": lambda nlev: (nlev + 1,),
    "PLU": lambda nlev: (nlev,),
    "PLUDE": lambda nlev: (nlev,),
    "PMFU": lambda nlev: (nlev,),
    "PMFD": lambda nlev: (nlev,),
    "PA": lambda nlev: (nlev,),
    "PCLV": lambda nlev: (NCLV, nlev),
    "PSUPSAT": lambda nlev: (nlev,),
    "TENDENCY_CML_T": lambda nlev: (nlev,),
    "TENDENCY_CML_A": lambda nlev: (nlev,),
    "TENDENCY_CML_Q": lambda nlev: (nlev,),
    "TENDENCY_CML_CLD": lambda nlev: (NCLV, nlev),
}

REFERENCE_FIELDS = {
    "PLUDE": lambda nlev: (nlev,),
    "PCOVPTOT": lambda nlev: (nlev,),
    "PFPLSL": lambda nlev: (nlev + 1,),
    "PFPLSN": lambda nlev: (nlev + 1,),
    "PFHPSL": lambda nlev: (nlev + 1,),
    "PFHPSN": lambda nlev: (nlev + 1,),
    "TENDENCY_LOC_A": lambda nlev: (nlev,),
    "TENDENCY_LOC_T": lambda nlev: (nlev,),
    "TENDENCY_LOC_Q": lambda nlev: (nlev,),
    "TENDENCY_LOC_CLD": lambda nlev: (NCLV, nlev),
}


class _NpzStore:
    """Dict-like wrapper so .npz archives satisfy the h5py read surface
    (f[k], k in f) used by the constant-group loaders."""

    def __init__(self, path):
        self._z = np.load(path)

    def __getitem__(self, k):
        return self._z[k]

    def __contains__(self, k):
        return k in self._z.files

    def keys(self):
        return self._z.files

    def close(self):
        self._z.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_store(path):
    """Open an input/reference archive for reading: NumPy (.npz) or HDF5
    (.h5), same field schema in both (file_io_mod.F90:13-37 selects the
    backend at compile time; here it is the file's extension)."""
    path = str(path)
    if path.endswith(".npz"):
        return _NpzStore(path)
    import h5py

    return h5py.File(path, "r")


def write_store(path, datasets) -> None:
    """Write a dict of datasets to ``.npz`` or ``.h5`` with the same names,
    dtypes and shapes (``cloudsc2jax/io.py:124``)."""
    path = str(path)
    if path.endswith(".npz"):
        np.savez(path, **{k: np.asarray(v) for k, v in datasets.items()})
        return
    import h5py

    with h5py.File(path, "w") as f:
        for k, v in datasets.items():
            f.create_dataset(k, data=np.asarray(v))


def h5_to_npz(src, dst) -> None:
    """Copy every dataset of an ``.h5`` store into a compressed ``.npz``
    with the same names, dtypes and shapes (how ``tests/fixtures/*.npz``
    are made from the ``.h5`` fixtures)."""
    with open_store(src) as f:
        datasets = {k: np.asarray(f[k]) for k in f.keys()}
    np.savez_compressed(dst, **datasets)


def _standard_atmosphere_t(z):
    """Piecewise-linear ICAO-like temperature profile T(z[m])."""
    # (z_base, T_base, lapse K/m)
    layers = [
        (0.0, 288.15, -6.5e-3),
        (11000.0, 216.65, 0.0),
        (20000.0, 216.65, 1.0e-3),
        (32000.0, 228.65, 2.8e-3),
        (47000.0, 270.65, 0.0),
        (51000.0, 270.65, -2.8e-3),
        (71000.0, 214.65, -2.0e-3),
    ]
    t = np.empty_like(z)
    for zb, tb, lr in layers:
        sel = z >= zb
        t[sel] = tb + lr * (z[sel] - zb)
    t[z < 0] = 288.15
    return t


def synthetic_state(
    nlon: int = 100,
    nlev: int = 137,
    seed: int = 2026,
    ptsphy: float = 3600.0,
) -> Tuple[Dict[str, np.ndarray], Params]:
    """Generate a physically-plausible input state.

    The same generator as :func:`cloudsc2jax.io.synthetic_state`, drawing
    from ``np.random.default_rng(seed)`` in the same order, so both packages
    build the same state from the same seed.  Returns ``(fields, params)``
    with fields in file order (trailing column axis, per INPUT_FIELDS) and
    CETA derived as the reference entry program does
    (dwarf_cloudsc.F90:100-102: CETA(jk)=PAP(1,jk,1)/PAPH(1,KLEV+1,1)).
    """
    import torch

    from .physics.satur import satur

    rng = np.random.default_rng(seed)

    # --- vertical grid: half levels quadratically refined towards the
    # surface (an IFS-like density), top at ~80 km.
    s = np.linspace(0.0, 1.0, nlev + 1)
    z_half = 80000.0 * (1.0 - s) ** 1.7  # (nlev+1,), z_half[-1]=0 (surface)

    ps = 101325.0 * (1.0 + 0.02 * rng.standard_normal(nlon)).clip(0.94, 1.04)

    # hydrostatic half-level pressure from the standard atmosphere
    t_prof = _standard_atmosphere_t(z_half)
    rd, g = 287.0597, 9.80665
    # integrate ln p upward from the surface
    lnp = np.zeros(nlev + 1)
    for k in range(nlev - 1, -1, -1):
        dz = z_half[k] - z_half[k + 1]
        tbar = 0.5 * (t_prof[k] + t_prof[k + 1])
        lnp[k] = lnp[k + 1] - g * dz / (rd * tbar)
    sigma_half = np.exp(lnp)  # 1 at surface, ~3e-6 at top
    paph = ps[None, :] * sigma_half[:, None]  # (nlev+1, nlon)
    pap = 0.5 * (paph[:-1] + paph[1:])  # (nlev, nlon)

    z_full = 0.5 * (z_half[:-1] + z_half[1:])
    t_base = _standard_atmosphere_t(z_full)  # (nlev,)

    # column-to-column variability: warm/cold columns, boundary-layer noise
    dt_col = 8.0 * rng.standard_normal(nlon)
    pt = t_base[:, None] + dt_col[None, :] * np.exp(-((z_full[:, None]) / 12000.0))
    pt += 0.8 * rng.standard_normal((nlev, nlon))
    pt = pt.clip(180.0, 320.0)

    # humidity: fraction of saturation with a moist lower troposphere;
    # qsat via the port's own SATUR, in float64 on the CPU
    params0 = Params.ifs_defaults(ceta=pap[:, 0] / paph[nlev, 0], ptsphy=ptsphy)
    qs = satur(torch.from_numpy(pap), torch.from_numpy(pt), params0,
               lphylin=True, kflag=2).numpy()
    rh = (
        0.55
        + 0.35 * np.exp(-z_full[:, None] / 3000.0)
        + 0.12 * np.sin(z_full[:, None] / 2500.0)
        + 0.18 * rng.standard_normal((1, nlon))
        + 0.06 * rng.standard_normal((nlev, nlon))
    ).clip(0.05, 1.05)
    # dry stratosphere: relax towards ~3 ppmv above ~200 hPa
    pfrac_full = pap / ps[None, :]
    strat = (pfrac_full < 0.2).astype(float)
    pq = (rh * qs).clip(1e-9, 0.03)
    pq = np.where(strat > 0, np.minimum(pq, 3.0e-6), pq)

    # cloud condensate: liquid in the 600-950 hPa band, ice at 200-600 hPa,
    # present in cloudy columns only
    cloudy = (rng.random(nlon) < 0.65).astype(float)
    pfrac = pap / ps[None, :]
    liq_band = np.exp(-(((pfrac - 0.8) / 0.12) ** 2))
    ice_band = np.exp(-(((pfrac - 0.4) / 0.15) ** 2))
    amp = rng.random(nlon) * cloudy
    ql = 2.5e-4 * liq_band * amp[None, :] * rng.random((nlev, nlon))
    qi = 1.2e-4 * ice_band * amp[None, :] * rng.random((nlev, nlon))

    pclv = np.zeros((NCLV, nlev, nlon))
    pclv[NCLDQL] = ql
    pclv[NCLDQI] = qi

    # cloud fraction consistent-ish with condensate
    pa = ((ql + qi) > 1e-7).astype(float) * (0.3 + 0.7 * rng.random((nlev, nlon)))

    # convection: updraught condensate/mass flux in ~40% of columns,
    # confined to the troposphere (taper to zero above ~300 hPa)
    conv = (rng.random(nlon) < 0.4).astype(float)
    conv_band = np.exp(-(((pfrac - 0.65) / 0.25) ** 2))
    conv_band *= np.clip((pfrac - 0.3) / 0.1, 0.0, 1.0)
    plu = 1.5e-4 * conv_band * conv[None, :] * rng.random((nlev, nlon))
    plude = 2.0e-5 * conv_band * conv[None, :] * rng.random((nlev, nlon))
    pmfu = 8.0e-3 * conv_band * conv[None, :] * rng.random((nlev, nlon))
    pmfd = -2.0e-3 * conv_band * conv[None, :] * rng.random((nlev, nlon))

    # accumulated tendencies from "other processes": small smooth fields,
    # vanishing in the upper stratosphere/mesosphere
    taper = np.clip(pfrac / 0.05, 0.0, 1.0)
    ten_t = 2.0e-5 * rng.standard_normal((nlev, nlon)) * (1.0 + 2.0 * pfrac) * taper
    ten_q = 1.0e-8 * rng.standard_normal((nlev, nlon)) * taper * (pfrac > 0.2)
    ten_cld = np.zeros((NCLV, nlev, nlon))
    ten_cld[NCLDQL] = 2.0e-9 * rng.standard_normal((nlev, nlon)) * (ql > 0)
    ten_cld[NCLDQI] = 1.0e-9 * rng.standard_normal((nlev, nlon)) * (qi > 0)
    ten_a = np.zeros((nlev, nlon))

    # supersaturation memory: small, only in cold tropospheric levels
    psupsat = np.where(
        (pt < 250.0) & (pfrac > 0.2), 2.0e-6 * rng.random((nlev, nlon)), 0.0
    )

    fields = {
        "PT": pt,
        "PQ": pq,
        "PAP": pap,
        "PAPH": paph,
        "PLU": plu,
        "PLUDE": plude,
        "PMFU": pmfu,
        "PMFD": pmfd,
        "PA": pa,
        "PCLV": pclv,
        "PSUPSAT": psupsat,
        "TENDENCY_CML_T": ten_t,
        "TENDENCY_CML_A": ten_a,
        "TENDENCY_CML_Q": ten_q,
        "TENDENCY_CML_CLD": ten_cld,
    }
    fields = {k: np.asarray(v, dtype=np.float64) for k, v in fields.items()}
    return fields, params0


def _columns_first(arr: np.ndarray) -> np.ndarray:
    """File order (…, nlev, nlon) -> framework order (nlon, …, nlev)."""
    return np.ascontiguousarray(np.moveaxis(arr, -1, 0))


def expand_columns(
    fields: Dict[str, np.ndarray], ngptot: int, columns_first: bool = False
) -> Dict[str, np.ndarray]:
    """Cyclically tile the stored columns up to ``ngptot`` grid points
    (EXPAND_R2/R3, expand_mod.F90:270-335).  ``columns_first=True``
    returns framework order ``(ngptot, …)``.  A host-side path: the main
    path expands on the device
    (:meth:`cloudsc2jax_torch.state.Cloudsc2State.device_kernel_inputs`).
    The native shim's memcpy sweep writes the columns-first layout
    directly; without it numpy tiles, to the same bits
    (``cloudsc2jax/io.py:283-312``)."""
    from .native import hostinfo

    out = {}
    for k, v in fields.items():
        nlon = v.shape[-1]
        src = np.ascontiguousarray(np.moveaxis(np.asarray(v, np.float64), -1, 0))
        dst = np.empty((ngptot,) + src.shape[1:], dtype=np.float64)
        if hostinfo.expand_f64(src, dst):
            out[k] = dst if columns_first else np.ascontiguousarray(
                np.moveaxis(dst, 0, -1))
            continue
        reps = -(-ngptot // nlon)
        tiled = np.tile(v, (1,) * (v.ndim - 1) + (reps,))[..., :ngptot]
        out[k] = _columns_first(tiled) if columns_first \
            else np.ascontiguousarray(tiled)
    return out


def load_input_h5(path, ngptot: Optional[int] = None):
    """Load (and optionally expand) an input store (``.h5`` or ``.npz``).

    Returns ``(fields, params)`` with fields in framework order
    ``(ncol, [nclv,] nlev)`` float64.
    """
    from .constants import Yoethf, Yomcst, Yomncl, Yophnc, Yrecldp, Yrephli
    from .errors import abor1

    with open_store(path) as f:
        for key in ("KLON", "KLEV", "PTSPHY", "PT", "PAP", "PAPH"):
            if key not in f:
                abor1(f"input store {path} is missing dataset {key}")
        nlev = int(f["KLEV"][0])
        ptsphy = float(f["PTSPHY"][0])
        missing = [
            k for k in INPUT_FIELDS
            if k not in f and k != "TENDENCY_CML_A"  # defaults to zeros
        ]
        if missing:
            abor1(f"input store {path} is missing datasets {missing}")
        raw = {k: np.asarray(f[k], dtype=np.float64) for k in INPUT_FIELDS if k in f}
        params = Params(
            yomcst=Yomcst.from_h5(f),
            yoethf=Yoethf.from_h5(f),
            yrecldp=Yrecldp.from_h5(f),
            yrephli=Yrephli.from_h5(f),
            yophnc=Yophnc.ifs_defaults(),
            yomncl=Yomncl.ifs_defaults(),
            ceta=tuple(
                (raw["PAP"][:, 0] / raw["PAPH"][nlev, 0]).tolist()
            ),
            ptsphy=ptsphy,
        )
    if "TENDENCY_CML_A" not in raw:
        raw["TENDENCY_CML_A"] = np.zeros_like(raw["PT"])
    if ngptot is not None:
        return expand_columns(raw, ngptot, columns_first=True), params
    return {k: _columns_first(v) for k, v in raw.items()}, params


def load_reference_h5(path, ngptot: Optional[int] = None):
    """Load golden outputs (``.h5`` or ``.npz``); returns fields in
    framework order."""
    with open_store(path) as f:
        raw = {k: np.asarray(f[k], dtype=np.float64) for k in REFERENCE_FIELDS if k in f}
    if ngptot is not None:
        return expand_columns(raw, ngptot, columns_first=True)
    return {k: _columns_first(v) for k, v in raw.items()}


def write_input_h5(path, fields: Dict[str, np.ndarray], params: Params) -> None:
    """Write an input store (``.npz`` or ``.h5``) with the reference schema
    (cloudsc2_array_state_mod.F90:161-199 and the yo*_LOAD_PARAMETERS
    readers): ``fields`` in file order ``(…, nlev, nlon)``, the run scalars,
    and every constant group, as ``cloudsc2jax/io.py:316`` writes it."""
    nlev = fields["PT"].shape[0]
    nlon = fields["PT"].shape[-1]
    ds: Dict[str, np.ndarray] = {
        "KLON": np.array([nlon], dtype=np.int32),
        "KLEV": np.array([nlev], dtype=np.int32),
        "PTSPHY": np.array([params.ptsphy]),
        "LDSLPHY": np.array([0], dtype=np.int32),
        "LDMAINCALL": np.array([0], dtype=np.int32),
    }
    for k, v in fields.items():
        ds[k] = np.asarray(v, dtype=np.float64)
    for grp in (params.yomcst, params.yoethf, params.yrecldp, params.yrephli):
        for k, v in grp.h5_items().items():
            if isinstance(v, (tuple, list, np.ndarray)):
                # array-valued parameters (YRECLDP_RBETA/RBETAP1(0:100),
                # yoecldp.F90:367-369)
                ds[k] = np.asarray(v, dtype=np.float64)
            elif isinstance(v, (bool, int, np.integer)):
                # logicals and integers are int datasets (file_io_mod's
                # logical and integer scalar readers)
                ds[k] = np.array([int(v)], dtype=np.int32)
            else:
                ds[k] = np.array([float(v)])
    write_store(path, ds)


# flux datasets the reference's golden file carries and CLOUDSC2 never writes
_REFERENCE_PLACEHOLDERS = ("PFSQLF", "PFSQIF", "PFCQLNG", "PFCQNNG", "PFSQRF",
                           "PFSQSF", "PFCQRNG", "PFCQSNG", "PFSQLTUR", "PFSQITUR")


def write_reference_h5(path, outputs: Dict[str, np.ndarray], extra: bool = True) -> None:
    """Write golden outputs (file order arrays) to ``.npz`` or ``.h5`` with
    the reference schema (cloudsc2_array_state_mod.F90:260-287
    WRITE_REFERENCE; ``cloudsc2jax/io.py:402``); ``extra`` adds the
    placeholder flux datasets of the reference file as zeros."""
    nlev, nlon = outputs["PCOVPTOT"].shape[-2:]
    ds: Dict[str, np.ndarray] = {
        "KLON": np.array([nlon], dtype=np.int32),
        "KLEV": np.array([nlev], dtype=np.int32),
        "KFLDX": np.array([0], dtype=np.int32),
    }
    for k, v in outputs.items():
        ds[k] = np.asarray(v, dtype=np.float64)
    if extra:
        for k in _REFERENCE_PLACEHOLDERS:
            ds.setdefault(k, np.zeros((nlev + 1, nlon)))
        ds.setdefault("PRAINFRAC_TOPRFZ", np.zeros((nlon,)))
    write_store(path, ds)
