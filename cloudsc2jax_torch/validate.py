"""Field-wise validation statistics.

Port of :mod:`cloudsc2jax.validate` (reference ``validate_mod.F90``):
per-field min/max of the result, max absolute error, average absolute
error per grid point, and relative error with the reference's three
denominator regimes (validate_mod.F90:263-296), printed as the same table
(cloudsc2_array_state_mod.F90:229-232) with ``!!!!`` flagging a relative
error above ``threshold`` × machine epsilon.

:func:`field_errors` works on host arrays; :func:`field_errors_torch` runs
the five reductions on the tensors' device and brings only scalars back;
:func:`fields_errors_torch` does so for many fields at once and, over a
column mesh, reduces the statistics over the lanes and the ranks (the
MPI_REDUCEs of validate_mod.F90:149-151).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "FieldErrors",
    "field_errors",
    "field_errors_torch",
    "fields_errors_torch",
    "validate",
    "print_validation",
]

_EPS = np.finfo(np.float64).eps


@dataclasses.dataclass
class FieldErrors:
    name: str
    ndim: int
    zminval: float
    zmaxval: float
    zmaxerr: float
    zerrsum: float
    zsum: float
    ngptot: int
    # machine epsilon of the run's working precision: the reference uses
    # EPSILON(1.0_JPRB), which is eps32 under -DSINGLE (validate_mod.F90:
    # 285-289 with parkind1.F90:40-44) — so f32 runs are judged in eps32
    eps: float = _EPS

    @property
    def avgpgp(self) -> float:
        return self.zerrsum / max(self.ngptot, 1)

    @property
    def relerr(self) -> float:
        """Relative error, reference regimes (validate_mod.F90:271-284)."""
        if self.zerrsum < self.eps:
            return 0.0
        if self.zsum < self.eps:
            return self.zerrsum / (1.0 + self.zsum)
        return self.zerrsum / self.zsum

    def passed(self, threshold: float = 10.0) -> bool:
        return self.relerr <= threshold * self.eps


def field_errors(name: str, result, reference, ngptot: Optional[int] = None) -> FieldErrors:
    eps = float(np.finfo(np.asarray(result).dtype).eps) \
        if np.asarray(result).dtype.kind == "f" else _EPS
    a = np.asarray(result, dtype=np.float64)
    b = np.asarray(reference, dtype=np.float64)
    ncols = a.shape[0]
    return FieldErrors(
        name=name,
        ndim=a.ndim,
        zminval=float(a.min()),
        zmaxval=float(a.max()),
        zmaxerr=float(np.abs(a - b).max()),
        zerrsum=float(np.abs(a - b).sum()),
        zsum=float(np.abs(b).sum()),
        ngptot=int(ngptot if ngptot is not None else ncols),
        eps=eps,
    )


def field_errors_torch(
    name: str, result: torch.Tensor, reference: torch.Tensor,
    ngptot: Optional[int] = None,
) -> FieldErrors:
    """Field statistics on the tensors' device.

    ``result`` and ``reference`` share shape, dtype and device (any
    strides).  The difference is taken in the working dtype, as the
    reference does; both sums accumulate in float64 whatever the working
    dtype, and one transfer brings the five scalars to the host."""
    return fields_errors_torch({name: [(result, reference)]}, ngptot)[name]


def _lane_stats(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """``(nfields, 6)`` float64 on the host: min, max, max |err|, sum |err|
    and sum |ref| of each field's ``(result, reference)`` pair, reduced on
    their device and brought over in one transfer, and its column count."""
    rows = []
    for result, reference in pairs:
        d = (result - reference).abs()
        rows.append(torch.stack([
            result.min().double(),
            result.max().double(),
            d.max().double(),
            d.sum(dtype=torch.float64),
            reference.abs().sum(dtype=torch.float64),
        ]))
    ncol = torch.tensor([[float(r.shape[0])] for r, _ in pairs], dtype=torch.float64)
    return torch.cat([torch.stack(rows).cpu(), ncol], dim=1)


def fields_errors_torch(
    fields: Dict[str, Sequence[Tuple[torch.Tensor, torch.Tensor]]],
    ngptot: Optional[int] = None,
    mesh=None,
) -> Dict[str, FieldErrors]:
    """:func:`field_errors_torch` of many fields over the lanes of a column
    mesh (``dist.ColumnMesh``; ``None``: one lane, one process).

    ``fields`` maps a name to one ``(result, reference)`` pair per local
    lane, ``(ncol, ...)`` with the lane's columns first, on the lane's
    device.  Each lane reduces all its fields on its device into one small
    tensor; the lanes are reduced on the host, and across the ranks one
    collective per kind carries every field: MIN of the minima, MAX of the
    maxima and of the largest errors, SUM of both sums and of the columns.
    ``ngptot`` defaults to that global column count.  Every rank gets the
    same statistics."""
    names = list(fields)
    nlanes = len(fields[names[0]])
    lanes = [_lane_stats([fields[k][lane] for k in names]) for lane in range(nlanes)]
    if mesh is None:
        if nlanes != 1:
            raise ValueError(f"{nlanes} lanes of fields need a mesh")
        stats = lanes[0]
    else:
        stats = torch.empty((len(names), 6), dtype=torch.float64)
        stats[:, 0] = mesh.reduce([x[:, 0] for x in lanes], "min")
        stats[:, 1:3] = mesh.reduce([x[:, 1:3] for x in lanes], "max")
        stats[:, 3:] = mesh.reduce([x[:, 3:] for x in lanes], "sum")
    out = {}
    for k, row in zip(names, stats.tolist()):
        result = fields[k][0][0]
        zmin, zmax, zmaxerr, zerrsum, zsum, ncol = row
        out[k] = FieldErrors(
            name=k,
            ndim=result.dim(),
            zminval=zmin,
            zmaxval=zmax,
            zmaxerr=zmaxerr,
            zerrsum=zerrsum,
            zsum=zsum,
            ngptot=int(ngptot if ngptot is not None else ncol),
            eps=float(torch.finfo(result.dtype).eps),
        )
    return out


def validate(
    results: Dict[str, np.ndarray],
    references: Dict[str, np.ndarray],
    ngptot: Optional[int] = None,
) -> Dict[str, FieldErrors]:
    return {
        k: field_errors(k, results[k], references[k], ngptot)
        for k in results
        if k in references
    }


def print_validation(
    errors: Dict[str, FieldErrors], threshold: float = 10.0, file=None
) -> bool:
    """Print the reference validation table; returns overall pass/fail."""
    file = file or sys.stderr
    print(
        f"{'Variable':>20} {'Dim':>3} {'MinValue':>20} {'MaxValue':>20}"
        f" {'AbsMaxErr':>20} {'AvgAbsErr/GP':>20} {'MaxRelErr-%':>20}",
        file=file,
    )
    ok = True
    for e in errors.values():
        flag = ""
        if not e.passed(threshold):
            flag = "  !!!!"
            ok = False
        print(
            f"{e.name:>20} {e.ndim:>3} {e.zminval:20.13e} {e.zmaxval:20.13e}"
            f" {e.zmaxerr:20.13e} {e.avgpgp:20.13e} {100.0*e.relerr:20.13e}{flag}",
            file=file,
        )
    return ok
