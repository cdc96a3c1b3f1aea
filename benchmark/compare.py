"""The comparison that decides ``correct``.

A call's inputs are stored columns tiled cyclically, so every column of its
outputs is the answer for one stored column, and every copy of a stored
column has to give the same answer.  Each field the call returned is held
to the reference's value of the same field at the same columns, in float64
on the outputs' device.  Two kinds of number are compared:

* ``primal``, ``tangent``, ``adjoint``: the share of the columns compared
  whose answer is off, that is, has a value of a field of that kind that
  misses the reference by more than the configuration's ``tolerance`` times
  the field's largest reference value (a field whose reference is all zero
  has to be zero).  A share, not the widest gap: float32 legitimately
  lands on the other side of one of the scheme's thresholds in about one
  stored column in 5,000, and a jump there moves the widest gap a
  hundredfold from seed to seed (PERF.md).
* ``copies``: the largest difference between two copies of one stored
  column in the outputs of one call, which has to be 0: it catches an
  answer altered in one place.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable

import torch

from . import fields

KINDS = {"": "primal", fields.TANGENT: "tangent", fields.ADJOINT: "adjoint"}
COPIES = "copies"


def kind(name: str) -> str:
    return KINDS.get(name[:2], "primal")


def _first_copies(stored: torch.Tensor, nlon: int) -> torch.Tensor:
    """For each compared column, the position of the first compared column
    that holds the same stored column."""
    first = torch.full((nlon,), -1, dtype=torch.long, device=stored.device)
    first.scatter_reduce_(0, stored, torch.arange(len(stored), device=stored.device),
                          reduce="amin", include_self=False)
    return first[stored]


def call_readings(outputs: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  columns: torch.Tensor, tolerance: float) -> dict:
    """The numbers of one call: its levels-major ``outputs`` ``(rows,
    len(columns))`` hold ``columns`` of a tiled set, ``ref`` the reference
    ``(nlon, rows)`` at the set's stored columns.  Returns each kind's share
    of columns off, ``copies``, and each kind's widest gap (``widest_<kind>``,
    shown, not compared)."""
    missing = set(ref) - set(outputs)
    if missing:
        raise ValueError(f"the call returned no {sorted(missing)}")
    nlon = next(iter(ref.values())).shape[0]
    device = next(iter(outputs.values())).device
    columns = columns.to(device)
    stored = columns % nlon
    first = _first_copies(stored, nlon)
    off: Dict[str, torch.Tensor] = {}
    res = {COPIES: 0.0}
    for name, r_all in ref.items():
        prog, k = outputs[name], kind(name)
        r_all = r_all.to(device, torch.float64)
        scale = float(r_all.abs().max())
        bad = off.setdefault(k, torch.zeros(len(columns), dtype=torch.bool, device=device))
        widest = torch.zeros((), dtype=torch.float64, device=device)
        copies = torch.zeros_like(widest)
        # a few levels at a time: the float64 copies stay small at any width
        for lo in range(0, prog.shape[0], 32):
            p = prog[lo:lo + 32].double()
            d = torch.nan_to_num((p - r_all[:, lo:lo + 32].T.index_select(1, stored)).abs(),
                                 nan=math.inf)
            widest = torch.maximum(widest, d.max())
            bad |= (d > tolerance * scale).any(dim=0)
            c = torch.nan_to_num((p - p.index_select(1, first)).abs(), nan=math.inf)
            copies = torch.maximum(copies, c.max())
        widest = float(widest)
        res[COPIES] = max(res[COPIES], float(copies))
        gap = widest / scale if scale else (0.0 if widest == 0.0 else math.inf)
        res["widest_" + k] = max(res.get("widest_" + k, 0.0), gap)
    for k, bad in off.items():
        res[k] = float(bad.double().mean())
    return res


def worst(readings: Iterable[dict]) -> dict:
    """Each number's worst over the calls compared."""
    out: dict = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def verdict(readings: dict, limits: Dict[str, float]):
    """``(correct, checks)``: each number compared beside its limit (the
    widest gaps are shown, not compared)."""
    checks = {k: {"value": readings[k], "limit": lim} for k, lim in limits.items()
              if k in readings}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
