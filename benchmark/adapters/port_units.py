"""The adapter of the CLOUDSC2 configurations to the system under test,
``cloudsc2jax_torch``: its ``Params`` built from the benchmark's constants,
its inputs from the benchmark's tiled sets, and the entry each contract
drives.

Contracts (a traffic file's ``contract``):

* ``stream``: levels-major inputs, ``drivers.run_nl(backend="streams")``
  (the 8 output streams) or ``drivers.run_tlad(backend="streams")``
  (the tangent streams and the levels-major adjoints; the 8 primal
  streams with ``write_primal``).
* ``standard``: the ``(ncol, nlev)`` contract on the transposed views of
  levels-major tensors (as ``state.device_inputs`` builds them),
  ``backend="kernels"``: the 10 outputs, and for the unit the 10 tangents
  and the 16 adjoints.

:func:`outputs` names every tensor a call returned, levels-major, under the
names of :mod:`benchmark.fields`.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import fields


def params(c, ceta: torch.Tensor, config: dict):
    """The system's ``Params`` with every constant CLOUDSC2 reads taken from
    ``c`` (the reference's constants) and the configuration's switches."""
    from cloudsc2jax_torch.constants import Params

    p = Params.ifs_defaults(ceta=ceta.tolist(), ptsphy=c.ptsphy)
    groups = {g: dataclasses.replace(getattr(p, g), **vars(getattr(c, g)))
              for g in ("yomcst", "yoethf", "yrecldp", "yrephli")}
    return p.replace(yophnc=dataclasses.replace(p.yophnc, levapls2=config["levapls2"]),
                     **groups)


def inputs(tiled: dict, config: dict, traffic: dict):
    """The system's inputs of one tiled set (levels-major tensors by name)."""
    from cloudsc2jax_torch.physics.cloudsc2 import Cloudsc2Inputs

    x = Cloudsc2Inputs(**{k: tiled.get(k) for k in Cloudsc2Inputs._fields})
    if traffic["contract"] == "standard":
        return Cloudsc2Inputs(*(None if v is None else v.T for v in x))
    return x


def entry(p, config: dict, traffic: dict):
    """The call the window drives: one argument, the system's inputs."""
    from cloudsc2jax_torch import drivers

    backend = {"stream": "streams", "standard": "kernels"}[traffic["contract"]]
    if config["unit"] == "nl":
        return lambda x: drivers.run_nl(x, p, backend=backend,
                                        ldrain1d=config["ldrain1d"])
    return lambda x: drivers.run_tlad(
        x, p, backend=backend, lregcl=config["lregcl"], ldrain1d=config["ldrain1d"],
        write_primal=traffic.get("write_primal", True))


def outputs(result, config: dict, traffic: dict) -> dict:
    """Every tensor of a call's result, levels-major, by name."""
    standard = traffic["contract"] == "standard"
    groups = (result,) if config["unit"] == "nl" else result
    prefixes = ("", fields.TANGENT, fields.ADJOINT)
    out = {}
    for prefix, group in zip(prefixes, groups):
        if group is None:
            continue
        for name, v in zip(group._fields, group):
            out[prefix + name] = v.T if standard else v
    return out
