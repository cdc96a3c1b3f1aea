"""Physics constants and configuration groups.

A copy of :mod:`cloudsc2jax.constants`, which holds no JAX code but cannot
be imported without JAX: ``cloudsc2jax/__init__.py`` imports the physics
eagerly.  Each reference parameter module
(``src/common/module/yomcst.F90``, ``yoethf.F90``, ``yoecldp.F90``,
``yoephli.F90``, ``yoecld.F90``, ``yophnc.F90``, ``yomncl.F90``) is a frozen
dataclass; the ``*_LOAD_PARAMETERS`` readers (e.g. ``yomcst.F90:167-177``,
``yoethf.F90:79-99``) are ``from_h5`` constructors that read any store from
:func:`cloudsc2jax_torch.io.open_store` (``.h5`` or ``.npz``), and every
group also has an ``ifs_defaults`` constructor carrying the standard IFS
values (SUCST/SUPHEC/SUCLDP/SUPHLI initialisations).

The groups are hashable, so a ``Params`` can key a cache.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = [
    "Yomcst",
    "Yoethf",
    "Yrecldp",
    "Yrephli",
    "Yophnc",
    "Yomncl",
    "Params",
    "NCLV",
    "NCLDQL",
    "NCLDQI",
    "NCLDQR",
    "NCLDQS",
    "NCLDQV",
]

# Microphysics species indices (reference: yoecldp.F90:86-91; 0-based here).
NCLV = 5
NCLDQL = 0  # liquid
NCLDQI = 1  # ice
NCLDQR = 2  # rain
NCLDQS = 3  # snow
NCLDQV = 4  # vapour


def _freeze(cls):
    return dataclass(frozen=True)(cls)


@_freeze
class Yomcst:
    """Fundamental constants (reference: yomcst.F90, loaded at :167-177)."""

    rg: float = 9.80665
    rd: float = 287.0596736665907
    rv: float = 461.5249933083879
    rcpd: float = 1004.7088578330674
    retv: float = 0.6077667316114637
    rlvtt: float = 2.5008e6
    rlstt: float = 2.8345e6
    rlmlt: float = 0.3337e6
    rtt: float = 273.16

    @classmethod
    def ifs_defaults(cls) -> "Yomcst":
        # SUCST: derived from Boltzmann/Avogadro and molar masses.
        rkbol = 1.380658e-23
        rnavo = 6.0221367e23
        r = rnavo * rkbol
        rmd = 28.9644
        rmv = 18.0153
        rd = 1000.0 * r / rmd
        rv = 1000.0 * r / rmv
        rlvtt = 2.5008e6
        rlstt = 2.8345e6
        return cls(
            rg=9.80665,
            rd=rd,
            rv=rv,
            rcpd=3.5 * rd,
            retv=rv / rd - 1.0,
            rlvtt=rlvtt,
            rlstt=rlstt,
            rlmlt=rlstt - rlvtt,
            rtt=273.16,
        )

    @classmethod
    def from_h5(cls, f) -> "Yomcst":
        g = lambda k: float(f[k][0])
        return cls(
            rg=g("RG"),
            rd=g("RD"),
            rv=g("RV"),
            rcpd=g("RCPD"),
            retv=g("RETV"),
            rlvtt=g("RLVTT"),
            rlstt=g("RLSTT"),
            rlmlt=g("RLMLT"),
            rtt=g("RTT"),
        )

    def h5_items(self):
        return {
            "RG": self.rg,
            "RD": self.rd,
            "RV": self.rv,
            "RCPD": self.rcpd,
            "RETV": self.retv,
            "RLVTT": self.rlvtt,
            "RLSTT": self.rlstt,
            "RLMLT": self.rlmlt,
            "RTT": self.rtt,
        }


@_freeze
class Yoethf:
    """Saturation-curve constants (reference: yoethf.F90, loaded at :79-99)."""

    r2es: float = 380.16
    r3les: float = 17.502
    r3ies: float = 22.587
    r4les: float = 32.19
    r4ies: float = -0.7
    # R5* and R5AL*CP are SUPHEC derivations (R5LES = R3LES*(RTT-R4LES),
    # R5ALVCP = R5LES*RLVTT/RCPD, ...); these literals must stay equal to
    # what ifs_defaults() computes — from_h5 overrides them from file
    r5les: float = 4217.45694
    r5ies: float = 6185.67582
    r5alvcp: float = 10497584.68169531
    r5alscp: float = 17451123.253362577
    ralvdcp: float = 2489.08
    ralsdcp: float = 2821.21
    ralfdcp: float = 332.14
    rtwat: float = 273.16
    rtice: float = 250.16
    rticecu: float = 250.16
    rtwat_rtice_r: float = 1.0 / 23.0
    rtwat_rticecu_r: float = 1.0 / 23.0
    rkoop1: float = 2.583
    rkoop2: float = 0.48116e-2
    rvtmp2: float = 0.0

    @classmethod
    def ifs_defaults(cls, cst: Yomcst) -> "Yoethf":
        # SUPHEC / su_yoethf derivations.
        restt = 611.21
        r3les, r3ies = 17.502, 22.587
        r4les, r4ies = 32.19, -0.7
        r5les = r3les * (cst.rtt - r4les)
        r5ies = r3ies * (cst.rtt - r4ies)
        rtwat = cst.rtt
        rtice = cst.rtt - 23.0
        return cls(
            r2es=restt * cst.rd / cst.rv,
            r3les=r3les,
            r3ies=r3ies,
            r4les=r4les,
            r4ies=r4ies,
            r5les=r5les,
            r5ies=r5ies,
            r5alvcp=r5les * cst.rlvtt / cst.rcpd,
            r5alscp=r5ies * cst.rlstt / cst.rcpd,
            ralvdcp=cst.rlvtt / cst.rcpd,
            ralsdcp=cst.rlstt / cst.rcpd,
            ralfdcp=cst.rlmlt / cst.rcpd,
            rtwat=rtwat,
            rtice=rtice,
            rticecu=rtice,
            rtwat_rtice_r=1.0 / (rtwat - rtice),
            rtwat_rticecu_r=1.0 / (rtwat - rtice),
            rkoop1=2.583,
            rkoop2=0.48116e-2,
            # The reference's GT4Py driver pins RVTMP2 to zero
            # (cloudsc2_inputs.py:110); IFS does the same in SUPHEC.
            rvtmp2=0.0,
        )

    @classmethod
    def from_h5(cls, f) -> "Yoethf":
        g = lambda k: float(f[k][0])
        return cls(
            r2es=g("R2ES"),
            r3les=g("R3LES"),
            r3ies=g("R3IES"),
            r4les=g("R4LES"),
            r4ies=g("R4IES"),
            r5les=g("R5LES"),
            r5ies=g("R5IES"),
            r5alvcp=g("R5ALVCP"),
            r5alscp=g("R5ALSCP"),
            ralvdcp=g("RALVDCP"),
            ralsdcp=g("RALSDCP"),
            ralfdcp=g("RALFDCP"),
            rtwat=g("RTWAT"),
            rtice=g("RTICE"),
            rticecu=g("RTICECU"),
            rtwat_rtice_r=g("RTWAT_RTICE_R"),
            rtwat_rticecu_r=g("RTWAT_RTICECU_R"),
            rkoop1=g("RKOOP1"),
            rkoop2=g("RKOOP2"),
            rvtmp2=0.0,
        )

    def h5_items(self):
        return {
            "R2ES": self.r2es,
            "R3LES": self.r3les,
            "R3IES": self.r3ies,
            "R4LES": self.r4les,
            "R4IES": self.r4ies,
            "R5LES": self.r5les,
            "R5IES": self.r5ies,
            "R5ALVCP": self.r5alvcp,
            "R5ALSCP": self.r5alscp,
            "RALVDCP": self.ralvdcp,
            "RALSDCP": self.ralsdcp,
            "RALFDCP": self.ralfdcp,
            "RTWAT": self.rtwat,
            "RTICE": self.rtice,
            "RTICECU": self.rticecu,
            "RTWAT_RTICE_R": self.rtwat_rtice_r,
            "RTWAT_RTICECU_R": self.rtwat_rticecu_r,
            "RKOOP1": self.rkoop1,
            "RKOOP2": self.rkoop2,
            "RVTMP2": self.rvtmp2,
        }


# The reference's YRECLDP_LOAD_PARAMETERS reader uses a handful of
# mixed-case dataset names (yoecldp.F90:281-289); everything else is the
# uppercased field name.
_YRECLDP_H5CASE = {
    "rcl_kkaac": "RCL_KKAac",
    "rcl_kkbac": "RCL_KKBac",
    "rcl_kkaau": "RCL_KKAau",
    "rcl_kkbauq": "RCL_KKBauq",
    "rcl_kkbaun": "RCL_KKBaun",
    "rcl_kk_cloud_num_sea": "RCL_KK_cloud_num_sea",
    "rcl_kk_cloud_num_land": "RCL_KK_cloud_num_land",
}

_ZERO101 = (0.0,) * 101


@_freeze
class Yrecldp:
    """Cloud-scheme tunables (reference: yoecldp.F90 TECLDP, read by
    YRECLDP_LOAD_PARAMETERS at :242-370 — 122 named scalars plus the
    RBETA/RBETAP1(0:100) arrays, all mirrored here so an input file
    written by :func:`cloudsc2jax.io.write_input_h5` carries every
    dataset the reference binaries read, and ``from_h5`` round-trips a
    reference-produced file).

    CLOUDSC2 itself (all three variants) consumes only RCLCRIT, RKCONV,
    RPECONS and RLMIN (cloudsc2.F90:222-224); those defaults are the
    authoritative SUCLDP values.  The remaining members exist purely for
    input-file interchangeability: the reference has **no** in-code
    defaults for them (values always come from input.h5), so the defaults
    below are representative IFS values where well known and documented
    zero placeholders for the derived microphysics constants (RCL_CONST*,
    RCL_X*, ... — computed from the A/B/C/D parameters in the full IFS
    setup, never referenced in this dwarf).
    """

    # --- consumed by CLOUDSC2 (authoritative SUCLDP defaults):
    # critical cloud water 0.3 g/kg, Sundqvist conversion time-scale
    # 6000 s, Kessler evaporation constant (RG*RPECONS = 5.44e-4), and
    # the condensate threshold.
    rclcrit: float = 0.3e-3
    rkconv: float = 1.0 / 6000.0
    rpecons: float = 5.547e-5
    rlmin: float = 1.0e-8

    # --- schema-parity members (reference reads them; CLOUDSC2 does not)
    ramid: float = 0.8
    rcldiff: float = 3.0e-6
    rcldiff_convi: float = 1.0
    rclcrit_sea: float = 0.25e-3
    rclcrit_land: float = 0.55e-3
    rprc1: float = 100.0
    rprc2: float = 0.5
    rcldmax: float = 5.0e-3
    rvrfactor: float = 5.09e-3
    rprecrhmax: float = 0.7
    rtaumel: float = 1.1880e4
    ramin: float = 1.0e-8
    rkooptau: float = 10800.0
    rcldtopp: float = 1000.0
    rlcritsnow: float = 3.0e-5
    rsnowlin1: float = 1.0e-3
    rsnowlin2: float = 0.025
    riceinit: float = 1.0e-12
    rvice: float = 0.13
    rvrain: float = 4.0
    rvsnow: float = 1.0
    rthomo: float = 235.16
    rcovpmin: float = 0.1
    rccn: float = 125.0
    rnice: float = 0.027
    rcldtopcf: float = 0.1
    rdepliqrefrate: float = 0.1
    rdepliqrefdepth: float = 500.0
    rdenswat: float = 1000.0
    rdensref: float = 1.0
    rcl_ka273: float = 2.4e-2
    rcl_schmidt: float = 0.6
    rcl_dynvisc: float = 1.717e-5
    # Khairoutdinov & Kogan (2000) autoconversion/accretion
    rcl_kkaac: float = 67.0
    rcl_kkbac: float = 1.15
    rcl_kkaau: float = 1350.0
    rcl_kkbauq: float = 2.47
    rcl_kkbaun: float = -1.79
    rcl_kk_cloud_num_sea: float = 50.0
    rcl_kk_cloud_num_land: float = 300.0
    # ice/snow/rain particle mass-diameter & fallspeed power laws
    rcl_ai: float = 0.069
    rcl_bi: float = 2.0
    rcl_ci: float = 16.8
    rcl_di: float = 0.527
    rcl_as: float = 0.069
    rcl_bs: float = 2.0
    rcl_cs: float = 16.8
    rcl_ds: float = 0.527
    rcl_ar: float = 523.6
    rcl_br: float = 3.0
    rcl_cr: float = 386.8
    rcl_dr: float = 0.67
    # derived microphysics constants: zero placeholders (see docstring)
    ricehi1: float = 0.0
    ricehi2: float = 0.0
    rcl_x1i: float = 0.0
    rcl_x2i: float = 0.0
    rcl_x3i: float = 0.0
    rcl_x4i: float = 0.0
    rcl_const1i: float = 0.0
    rcl_const2i: float = 0.0
    rcl_const3i: float = 0.0
    rcl_const4i: float = 0.0
    rcl_const5i: float = 0.0
    rcl_const6i: float = 0.0
    rcl_apb1: float = 0.0
    rcl_apb2: float = 0.0
    rcl_apb3: float = 0.0
    rcl_x1s: float = 0.0
    rcl_x2s: float = 0.0
    rcl_x3s: float = 0.0
    rcl_x4s: float = 0.0
    rcl_const1s: float = 0.0
    rcl_const2s: float = 0.0
    rcl_const3s: float = 0.0
    rcl_const4s: float = 0.0
    rcl_const5s: float = 0.0
    rcl_const6s: float = 0.0
    rcl_const7s: float = 0.0
    rcl_const8s: float = 0.0
    rcl_x1r: float = 0.0
    rcl_x2r: float = 0.0
    rcl_x4r: float = 0.0
    rcl_cdenom1: float = 0.0
    rcl_cdenom2: float = 0.0
    rcl_cdenom3: float = 0.0
    rcl_const1r: float = 0.0
    rcl_const2r: float = 0.0
    rcl_const3r: float = 0.0
    rcl_const4r: float = 0.0
    rcl_fac1: float = 0.0
    rcl_fac2: float = 0.0
    rcl_const5r: float = 0.0
    rcl_const6r: float = 0.0
    rcl_fzrab: float = 0.0
    rcl_fzrbb: float = 0.0
    rccnom: float = 0.3
    rccnss: float = 0.1
    rccnsu: float = 0.5
    # logical switches (stored as ints in the file)
    lcldextra: bool = False
    lcldbudget: bool = False
    laerliqautolsp: bool = False
    laerliqautocp: bool = False
    laerliqautocpb: bool = False
    laerliqcoll: bool = False
    laericesed: bool = False
    laericeauto: bool = False
    # integer indices/options
    nssopt: int = 1
    ncldtop: int = 13
    naeclbc: int = 0
    naecldu: int = 0
    naeclom: int = 0
    naeclss: int = 0
    naeclsu: int = 0
    nclddiag: int = 0
    naercld: int = 0
    # total-water-variance shape parameters (REAL despite the N prefix,
    # yoecldp.F90:229-230) and the beta-distribution tables
    nshapep: float = 0.0
    nshapeq: float = 0.0
    nbeta: int = 100
    rbeta: Tuple[float, ...] = _ZERO101
    rbetap1: Tuple[float, ...] = _ZERO101

    @classmethod
    def ifs_defaults(cls) -> "Yrecldp":
        return cls()

    @staticmethod
    def _h5name(field_name: str) -> str:
        return "YRECLDP_" + _YRECLDP_H5CASE.get(field_name, field_name.upper())

    @classmethod
    def from_h5(cls, f) -> "Yrecldp":
        """Read every YRECLDP_* dataset present (missing ones keep the
        defaults, so pre-schema-completion archives still load)."""
        d = cls()
        kw = {}
        for fld in dataclasses.fields(cls):
            key = cls._h5name(fld.name)
            if key not in f:
                kw[fld.name] = getattr(d, fld.name)
            elif fld.type == "bool":
                kw[fld.name] = bool(int(f[key][0]))
            elif fld.type == "int":
                kw[fld.name] = int(f[key][0])
            elif fld.name in ("rbeta", "rbetap1"):
                kw[fld.name] = tuple(float(v) for v in f[key][...].ravel())
            else:
                kw[fld.name] = float(f[key][0])
        return cls(**kw)

    def h5_items(self):
        return {
            self._h5name(fld.name): getattr(self, fld.name)
            for fld in dataclasses.fields(self)
        }


@_freeze
class Yrephli:
    """Linearised-physics constants (reference: yoephli.F90 TEPHLI, all 16
    members read by YREPHLI_LOAD_PARAMETERS at :79-97 and mirrored here
    for input-file interchangeability).

    The entry programs force LPHYLIN=.TRUE. (dwarf_cloudsc.F90:107).
    RLPTRC is the mixed-phase transition temperature used by the tanh
    water-fraction approximation (cloudsc2.F90:350); SUPHLI sets it to
    RTICE + (RTT-RTICE)/sqrt(2).  The Louis/boundary-layer members
    (RLPBB..RLPP00) are never referenced by this dwarf's kernels; their
    defaults are the standard SUPHLI values.
    """

    lphylin: bool = True
    ltlevol: bool = False
    lenopert: bool = True
    leppcfls: bool = False
    lraisanen: bool = False
    rlptrc: float = 266.425
    rlpal1: float = 0.15
    rlpal2: float = 20.0
    rlpbb: float = 5.0
    rlpcc: float = 5.0
    rlpdd: float = 5.0
    rlpmixl: float = 4000.0
    rlpbeta: float = 0.2
    rlpdrag: float = 0.0
    rlpevap: float = 0.0
    rlpp00: float = 30000.0

    @classmethod
    def ifs_defaults(cls) -> "Yrephli":
        rtt, rtice = 273.16, 250.16
        return cls(rlptrc=rtice + (rtt - rtice) / math.sqrt(2.0))

    @classmethod
    def from_h5(cls, f) -> "Yrephli":
        d = cls()
        kw = {}
        for fld in dataclasses.fields(cls):
            key = "YREPHLI_" + fld.name.upper()
            if key not in f:
                kw[fld.name] = getattr(d, fld.name)
            elif fld.type == "bool":
                kw[fld.name] = bool(int(f[key][0]))
            else:
                kw[fld.name] = float(f[key][0])
        # LPHYLIN is forced by the entry program, as in the reference
        kw["lphylin"] = True
        return cls(**kw)

    def h5_items(self):
        return {
            "YREPHLI_" + fld.name.upper(): getattr(self, fld.name)
            for fld in dataclasses.fields(self)
        }


@_freeze
class Yophnc:
    """Non-conservation / evaporation switches (reference: yophnc.F90).

    The entry programs allocate YRPHNC with LEVAPLS2=.FALSE.
    (dwarf_cloudsc.F90:104-105), disabling the clear-sky precipitation
    evaporation branch unless LDRAIN1D is set (cloudsc2.F90:557).
    """

    levapls2: bool = False

    @classmethod
    def ifs_defaults(cls) -> "Yophnc":
        return cls()


@_freeze
class Yomncl:
    """TL/AD regularisation switch (reference: yomncl.F90:24-29).

    LREGCL=.FALSE. for the Taylor (TL) test and .TRUE. for the adjoint
    test, mirroring the entry-program diff
    (cloudsc2_tl/dwarf_cloudsc.F90:103-105 vs cloudsc2_ad/...:105).
    """

    lregcl: bool = False

    @classmethod
    def ifs_defaults(cls) -> "Yomncl":
        return cls()


@_freeze
class Params:
    """Aggregate of every constant group consumed by the physics kernels.

    ``ceta`` — the eta coordinate of each full level (reference: YRECLD%CETA,
    built by the entry program as PAP(1,:,1)/PAPH(1,KLEV+1,1),
    dwarf_cloudsc.F90:100-102) — is a *tuple* so the whole Params object
    stays hashable / jit-static.
    """

    yomcst: Yomcst
    yoethf: Yoethf
    yrecldp: Yrecldp
    yrephli: Yrephli
    yophnc: Yophnc
    yomncl: Yomncl
    ceta: Tuple[float, ...]
    ptsphy: float = 3600.0

    @classmethod
    def ifs_defaults(cls, ceta, ptsphy: float = 3600.0) -> "Params":
        cst = Yomcst.ifs_defaults()
        return cls(
            yomcst=cst,
            yoethf=Yoethf.ifs_defaults(cst),
            yrecldp=Yrecldp.ifs_defaults(),
            yrephli=Yrephli.ifs_defaults(),
            yophnc=Yophnc.ifs_defaults(),
            yomncl=Yomncl.ifs_defaults(),
            ceta=tuple(float(c) for c in ceta),
            ptsphy=float(ptsphy),
        )

    def replace(self, **kw) -> "Params":
        return dataclasses.replace(self, **kw)

    @property
    def nlev(self) -> int:
        return len(self.ceta)
