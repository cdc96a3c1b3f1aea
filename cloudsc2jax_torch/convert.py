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

__all__ = ["params_from_jax", "inputs_from_numpy", "contract_from_numpy",
           "encoded_from_numpy"]

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


def contract_from_numpy(tree, cls=Cloudsc2Inputs, device="cpu",
                        dtype: torch.dtype = torch.float64):
    """A NamedTuple of ``(ncol, nlev)`` host arrays (a JAX-side
    ``Cloudsc2Inputs``, increments, ``Cloudsc2Outputs`` cotangents) -> the
    port's ``cls`` with the same fields, as tensors on ``device`` in the
    same ``(ncol, nlev)`` layout: the standard contract of the truth path
    and of the kernels' standard wrappers."""
    return cls(*(
        torch.from_numpy(np.array(getattr(tree, name))).to(device=device, dtype=dtype)
        for name in cls._fields
    ))


def encoded_from_numpy(streams, enc, ztrpaus, paphsfc, device="cpu"):
    """A JAX-side ``EncodedInputs`` as host arrays -> the port's
    :class:`~cloudsc2jax_torch.kernels.experiments.EncodedInputs`, bit for
    bit: blocked ``(nlev, nb, S, 128)`` payloads (int16, bfloat16 or f32)
    become levels-major ``(nlev, ncol)`` (numpy has no bfloat16 of its own:
    a 2-byte float array that is not float16 is carried across as its bit
    patterns), the ``(n_streams+1, nlev+1, 2)`` table
    loses its duplicated last row (the TPU kernel's second paph window),
    and the blocked per-column operands become ``(ncol,)``."""
    from .kernels.experiments import EncodedInputs

    def lm(x, lead):
        x = np.asarray(x)
        bf16 = x.dtype.kind not in "iu" and x.dtype.itemsize == 2 \
            and x.dtype != np.float16
        if bf16:
            x = x.view(np.int16)
        out = torch.from_numpy(
            np.ascontiguousarray(x.reshape(*x.shape[:lead], -1)))
        return (out.view(torch.bfloat16) if bf16 else out).to(device)

    table = np.asarray(enc, np.float32)
    if table.shape[0] != len(streams) + 1:
        raise ValueError(f"expected a table of {len(streams) + 1} rows for "
                         f"{len(streams)} streams, got {table.shape[0]}")
    return EncodedInputs(
        streams=tuple(lm(s, 1) for s in streams),
        enc=torch.from_numpy(np.ascontiguousarray(table[:-1])).to(device),
        ztrpaus=lm(ztrpaus, 0), paphsfc=lm(paphsfc, 0))
