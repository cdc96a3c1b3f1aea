"""The IFS constants that CLOUDSC2 reads, frozen for the benchmark.

Derived as SUCST and SUPHEC derive them (the upstream dwarf's
``yomcst.F90``, ``yoethf.F90``, ``yoecldp.F90``, ``yoephli.F90``,
``yophnc.F90``), with RVTMP2 pinned to zero as the upstream drivers pin it.
Both sides of a comparison take their constants from here: the plain
reference directly, the system under test through its configuration's
adapter.
"""

from __future__ import annotations

import math

# SUCST: fundamental constants from Boltzmann's and Avogadro's numbers
_RKBOL = 1.380658e-23
_RNAVO = 6.0221367e23
_R = _RNAVO * _RKBOL
_RD = 1000.0 * _R / 28.9644
_RV = 1000.0 * _R / 18.0153
_RLVTT = 2.5008e6
_RLSTT = 2.8345e6
_RTT = 273.16
_RCPD = 3.5 * _RD

YOMCST = {
    "rg": 9.80665,
    "rd": _RD,
    "rv": _RV,
    "rcpd": _RCPD,
    "retv": _RV / _RD - 1.0,
    "rlvtt": _RLVTT,
    "rlstt": _RLSTT,
    "rlmlt": _RLSTT - _RLVTT,
    "rtt": _RTT,
}

# SUPHEC: saturation curves
_R3LES, _R3IES = 17.502, 22.587
_R4LES, _R4IES = 32.19, -0.7
_R5LES = _R3LES * (_RTT - _R4LES)
_R5IES = _R3IES * (_RTT - _R4IES)
_RTICE = _RTT - 23.0

YOETHF = {
    "r2es": 611.21 * _RD / _RV,
    "r3les": _R3LES,
    "r3ies": _R3IES,
    "r4les": _R4LES,
    "r4ies": _R4IES,
    "r5les": _R5LES,
    "r5ies": _R5IES,
    "r5alvcp": _R5LES * _RLVTT / _RCPD,
    "r5alscp": _R5IES * _RLSTT / _RCPD,
    "ralvdcp": _RLVTT / _RCPD,
    "ralsdcp": _RLSTT / _RCPD,
    "rtwat": _RTT,
    "rtice": _RTICE,
    "rtwat_rtice_r": 1.0 / (_RTT - _RTICE),
    "rvtmp2": 0.0,
}

# YRECLDP: the four members CLOUDSC2 reads
YRECLDP = {
    "rclcrit": 0.3e-3,
    "rkconv": 1.0 / 6000.0,
    "rpecons": 5.547e-5,
    "rlmin": 1.0e-8,
}

# YREPHLI: the mixed-phase transition temperature of the tanh water fraction
YREPHLI = {
    "lphylin": True,
    "rlptrc": _RTICE + (_RTT - _RTICE) / math.sqrt(2.0),
}

GROUPS = {"yomcst": YOMCST, "yoethf": YOETHF, "yrecldp": YRECLDP,
          "yrephli": YREPHLI}
