"""The control: the plain reference put in the system's place, one precision
below the configuration's float32.

Every input stream is stored in bfloat16, as the system's encoded sweeps'
bfloat16 payloads store theirs, with ``paph`` kept in float32 as they keep
it; the arithmetic is float32.  (The whole reference in bfloat16 gives no
number: adjacent half-level pressures near the surface round to one
bfloat16 value, and the layer thickness of zero makes NaNs.)  The reference
runs on the set's stored columns, which the tiled set holds as its first
columns, and its outputs are tiled back to the cell's columns.  The
comparison has to find this not correct.
"""

from __future__ import annotations

import torch

from .. import fields
from ..reference import physics

KEEP_F32 = ("paph",)


def params(c, ceta, config):
    return (c, ceta)


def inputs(tiled: dict, config: dict, traffic: dict):
    nlon = config["stored_columns"]
    return {k: (v[:, :nlon] if k in KEEP_F32 else
                v[:, :nlon].to(torch.bfloat16)).float().T for k, v in tiled.items()}


def entry(p, config: dict, traffic: dict):
    c, ceta = p
    names = fields.expected(config["unit"], traffic["contract"],
                            traffic.get("write_primal", True))

    def call(x):
        if config["unit"] == "nl":
            ref = (physics.nl(x, ceta, c, ldrain1d=config["ldrain1d"]),)
        else:
            ref = physics.tlad(x, ceta, c, dscale=config["dscale"],
                               lregcl=config["lregcl"], ldrain1d=config["ldrain1d"])
        idx = torch.arange(config["ngptot"], device=x["pt"].device) % config["stored_columns"]
        return {k: v.detach().T.index_select(1, idx)
                for k, v in fields.reference_fields(ref, names).items()}

    return call


def outputs(result, config: dict, traffic: dict) -> dict:
    return result
