"""Carry parameters and states from the JAX package into the port.

Neither function imports JAX: the JAX side's objects are read by duck
typing, so the tests can feed both packages exactly the same things.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .constants import Params, Yoethf, Yomcst, Yomncl, Yophnc, Yrecldp, Yrephli
from .physics.cloudsc2 import Cloudsc2Inputs

__all__ = ["params_from_jax", "inputs_from_numpy"]

_GROUPS = {
    "yomcst": Yomcst,
    "yoethf": Yoethf,
    "yrecldp": Yrecldp,
    "yrephli": Yrephli,
    "yophnc": Yophnc,
    "yomncl": Yomncl,
}


def params_from_jax(p) -> Params:
    """The port's :class:`Params` from a ``cloudsc2jax.constants.Params``
    (any frozen dataclass with the same fields)."""
    d = dataclasses.asdict(p)
    return Params(
        **{name: cls(**d[name]) for name, cls in _GROUPS.items()},
        ceta=tuple(float(c) for c in d["ceta"]),
        ptsphy=float(d["ptsphy"]),
    )


def inputs_from_numpy(inputs_cm, device="cpu",
                      dtype: torch.dtype = torch.float64) -> Cloudsc2Inputs:
    """A ``(ncol, nlev)`` Cloudsc2Inputs of host arrays (numpy or anything
    ``np.asarray`` takes) -> levels-major tensors on ``device``."""
    return Cloudsc2Inputs(*(
        torch.from_numpy(
            np.ascontiguousarray(np.asarray(getattr(inputs_cm, name)).T)
        ).to(device=device, dtype=dtype)
        for name in Cloudsc2Inputs._fields
    ))
