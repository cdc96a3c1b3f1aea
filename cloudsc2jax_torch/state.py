"""Array state: load, expand on the device, validate, write a golden file.

Port of :mod:`cloudsc2jax.state` (reference
``src/common/module/cloudsc2_array_state_mod.F90``).  The host keeps the
stored columns in framework order ``(ncol, [nclv,] nlev)``; the main path
ships only those to the device, once per dtype and device, and expands them
there (:func:`tile_stored_columns`), straight into the levels-major
``(nlev[+1], ngptot)`` layout the kernel reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from . import io as cio
from . import validate as cval
from .constants import NCLDQI, NCLDQL, NCLV, Params
from .physics.cloudsc2 import Cloudsc2Inputs, Cloudsc2Outputs
from .physics.satur import satur

__all__ = ["Cloudsc2State", "tile_stored_columns"]


def tile_stored_columns(base: Cloudsc2Inputs, ncol: int,
                        col_offset: int = 0) -> Cloudsc2Inputs:
    """Cyclic expansion of device-resident stored columns (the port's
    ``blockify_columns``, ``cloudsc2jax/state.py:27``): ``base`` holds the
    ``klon`` stored columns levels-major, ``(nlev[+1], klon)``; column i of
    the result holds stored column ``(col_offset + i) % klon``, on
    ``base``'s device, with no host transfer and no synchronisation.
    ``None`` fields stay ``None``."""
    klon = base.pt.shape[1]
    idx = torch.arange(col_offset, col_offset + ncol, device=base.pt.device) % klon
    return Cloudsc2Inputs(
        *(None if x is None else x.index_select(1, idx) for x in base))


def _tile_columns(x: np.ndarray, ncol: int, like: torch.Tensor) -> torch.Tensor:
    """Cyclic column expansion on ``like``'s device and dtype (EXPAND_R2/R3,
    expand_mod.F90:270-335): ``(klon, ...)`` host array -> ``(ncol, ...)``
    view of a column-last tensor, the memory layout of the outputs."""
    t = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, 0, -1)))
    t = t.to(device=like.device, dtype=like.dtype)
    idx = torch.arange(ncol, device=like.device) % t.shape[-1]
    return t.index_select(-1, idx).movedim(-1, 0)


@dataclasses.dataclass
class Cloudsc2State:
    """All model fields in framework order ``(ncol, [nclv,] nlev)``."""

    fields: Dict[str, np.ndarray]
    params: Params
    ngptot: int
    klon_file: int  # columns stored in the source file (100 upstream)
    # (dtype, device) -> the stored columns there (stored_inputs)
    _resident: dict = dataclasses.field(default_factory=dict, init=False,
                                        repr=False, compare=False)

    # ------------------------------------------------------------------ load
    @classmethod
    def load(cls, path, ngptot: Optional[int] = None) -> "Cloudsc2State":
        """LOAD (cloudsc2_array_state_mod.F90:153-203).  The host keeps the
        stored columns only; expansion to ``ngptot`` happens on the device
        (:meth:`device_kernel_inputs`)."""
        fields, params = cio.load_input_h5(path)
        klon_file = fields["PT"].shape[0]
        return cls(fields=fields, params=params, ngptot=ngptot or klon_file,
                   klon_file=klon_file)

    @classmethod
    def synthetic(cls, ngptot: int = 100, nlev: int = 137, seed: int = 2026) -> "Cloudsc2State":
        raw, params = cio.synthetic_state(nlon=min(ngptot, 100), nlev=nlev, seed=seed)
        fields = cio.expand_columns(raw, ngptot, columns_first=True)
        return cls(fields=fields, params=params, ngptot=ngptot, klon_file=min(ngptot, 100))

    # ------------------------------------------------------------- kernel IO
    def qsat(self, dtype: torch.dtype = torch.float64, device="cpu") -> torch.Tensor:
        """SATUR of the state's fields cast to ``dtype``, in framework order
        ``(ncol, nlev)`` on ``device``: the driver's PQS
        (cloudsc_driver_mod.F90:91-92)."""
        def put(name):
            return torch.from_numpy(np.asarray(self.fields[name])).to(
                device=device, dtype=dtype)

        return satur(put("PAP"), put("PT"), self.params, lphylin=True, kflag=2)

    def kernel_inputs(self, dtype: torch.dtype = torch.float64,
                      device="cpu") -> Cloudsc2Inputs:
        """The 16 kernel inputs of the ``klon_file`` stored columns as
        levels-major tensors on ``device`` (``(nlev, ncol)``, paph
        ``(nlev+1, ncol)``); PQS is SATUR of the state in ``dtype``
        (cloudsc_driver_mod.F90:91-92)."""
        base = self._stored_inputs(dtype, device)
        return base._replace(
            pqs=satur(base.pap, base.pt, self.params, lphylin=True, kflag=2))

    def _stored_inputs(self, dtype: torch.dtype, device) -> Cloudsc2Inputs:
        """:meth:`kernel_inputs` without PQS (``None``)."""
        f = self.fields

        def put(x):
            x = np.ascontiguousarray(np.asarray(x)[: self.klon_file].T)
            return torch.from_numpy(x).to(device=device, dtype=dtype)

        return Cloudsc2Inputs(
            paph=put(f["PAPH"]),
            pap=put(f["PAP"]),
            pq=put(f["PQ"]),
            pqs=None,
            pt=put(f["PT"]),
            pl=put(f["PCLV"][:, NCLDQL]),
            pi=put(f["PCLV"][:, NCLDQI]),
            plude=put(f["PLUDE"]),
            plu=put(f["PLU"]),
            pmfu=put(f["PMFU"]),
            pmfd=put(f["PMFD"]),
            ten_t=put(f["TENDENCY_CML_T"]),
            ten_q=put(f["TENDENCY_CML_Q"]),
            ten_l=put(f["TENDENCY_CML_CLD"][:, NCLDQL]),
            ten_i=put(f["TENDENCY_CML_CLD"][:, NCLDQI]),
            psupsat=put(f["PSUPSAT"]),
        )

    def stored_inputs(self, dtype: torch.dtype = torch.float32, device="cuda",
                      pqs: bool = False) -> Cloudsc2Inputs:
        """:meth:`kernel_inputs` (``pqs=True``) or its fields without PQS,
        uploaded to ``device`` once per dtype and device and kept there: the
        device-resident base that :func:`tile_stored_columns` expands.  PQS
        is computed once, on the device, the first time it is asked for.
        The tensors are shared between calls and must not be written to."""
        key = (dtype, torch.device(device))
        base = self._resident.get(key)
        if base is None:
            base = self._resident[key] = self._stored_inputs(dtype, device)
        if pqs and base.pqs is None:
            base = self._resident[key] = base._replace(
                pqs=satur(base.pap, base.pt, self.params, lphylin=True, kflag=2))
        return base if pqs else base._replace(pqs=None)

    def device_kernel_inputs(
        self, ngptot: Optional[int] = None, dtype: torch.dtype = torch.float32,
        device="cuda", pqs: bool = False, col_offset: int = 0,
    ) -> Cloudsc2Inputs:
        """Levels-major kernel inputs expanded to ``ngptot`` columns ON THE
        DEVICE.  Only the ``klon_file`` stored columns cross to the device
        (~1 MB), once per dtype and device (:meth:`stored_inputs`);
        :func:`tile_stored_columns` tiles them cyclically straight into
        ``(nlev[+1], ngptot)``, the kernel's layout, with no padding.

        ``pqs=False`` (the NL sweep, which computes qsat from pt and pap
        itself) leaves ``pqs`` as ``None``.  ``pqs=True`` (the TL/AD sweeps,
        which read it as an independent input) runs SATUR on the stored
        columns in ``dtype`` (once) and tiles the result like the other
        fields, as the JAX package does (``cloudsc2jax/state.py:147-215``).

        ``col_offset`` starts the cyclic expansion at that global column:
        column i holds stored column ``(col_offset + i) % klon_file``, so a
        process or a chunk that materialises the global columns [o, o+n)
        passes ``col_offset=o`` (expand_mod.F90:30-46)."""
        return tile_stored_columns(self.stored_inputs(dtype, device, pqs),
                                   ngptot or self.ngptot, col_offset)

    def device_inputs(
        self, ngptot: Optional[int] = None, dtype: torch.dtype = torch.float64,
        device="cuda",
    ) -> Cloudsc2Inputs:
        """The 16 inputs in the standard ``(ncol, nlev)`` contract (paph
        ``(ncol, nlev+1)``) with ``pqs``, expanded to ``ngptot`` columns on
        the device, as the JAX package's non-blocked
        ``device_kernel_inputs`` returns them (``cloudsc2jax/state.py:170``).

        Each field is the transposed view of the levels-major tensor
        :meth:`device_kernel_inputs` builds, so the truth path reads one
        level of all columns as a contiguous row, and the kernels' wrappers
        get back to levels-major without a copy."""
        lm = self.device_kernel_inputs(ngptot, dtype=dtype, device=device, pqs=True)
        return Cloudsc2Inputs(*(x.T for x in lm))

    def output_dict(self, out: Cloudsc2Outputs) -> Dict[str, np.ndarray]:
        """Kernel outputs as host arrays under the golden-file field names.

        TENDENCY_LOC_A and the rain/snow/vapour species of TENDENCY_LOC_CLD
        are never written by the NL kernel and validate as zero; PLUDE is
        IN-only for CLOUDSC2 and passes through from the input state.
        """
        def host(x):
            return x.detach().to("cpu", torch.float64).numpy()

        ncol, nlev = out.pclc.shape
        cld = np.zeros((ncol, NCLV, nlev))
        cld[:, NCLDQL] = host(out.tenl_l)
        cld[:, NCLDQI] = host(out.tenl_i)
        return {
            "PLUDE": np.asarray(self.fields["PLUDE"], np.float64)[
                np.arange(ncol) % self.klon_file],
            "PCOVPTOT": host(out.pcovptot),
            "PFPLSL": host(out.pfplsl),
            "PFPLSN": host(out.pfplsn),
            "PFHPSL": host(out.pfhpsl),
            "PFHPSN": host(out.pfhpsn),
            "TENDENCY_LOC_A": np.zeros((ncol, nlev)),
            "TENDENCY_LOC_T": host(out.tenl_t),
            "TENDENCY_LOC_Q": host(out.tenl_q),
            "TENDENCY_LOC_CLD": cld,
        }

    # -------------------------------------------------------------- validate
    def validate(self, out: Cloudsc2Outputs, reference_path,
                 threshold: float = 10.0, quiet: bool = False) -> bool:
        """VALIDATE on the host (…array_state_mod.F90:205-258): the
        ``(ncol, nlev)`` outputs, brought to the host in float64, against the
        golden ``klon_file`` columns expanded cyclically to ``ngptot``, which
        is exact because expansion replicates the inputs.  As in the JAX
        package's host path, the statistics are those of float64 arrays,
        judged in float64 epsilons whatever the working precision."""
        ref = cio.load_reference_h5(reference_path, ngptot=self.ngptot)
        res = self.output_dict(out)
        errors = cval.validate(res, ref, ngptot=self.ngptot)
        if quiet:
            return all(e.passed(threshold) for e in errors.values())
        return cval.print_validation(errors, threshold)

    def validate_device(
        self,
        out: Cloudsc2Outputs,
        inputs: Cloudsc2Inputs,
        reference_path,
        threshold: float = 10.0,
        quiet: bool = False,
    ) -> bool:
        """VALIDATE (…array_state_mod.F90:205-258) with statistics on the
        outputs' device.

        ``out`` is the ``(ncol, nlev)`` contract and ``inputs`` the
        levels-major kernel inputs.  The golden ``klon_file`` columns are
        tiled on the device in the outputs' dtype and memory layout, and
        each field's five reductions run there (:func:`field_errors_torch`):
        only scalars reach the host, at any NGPTOT.
        """
        ncol, nlev = out.pclc.shape
        ref = cio.load_reference_h5(reference_path)
        cld = torch.zeros((NCLV, nlev, ncol), dtype=out.pclc.dtype,
                          device=out.pclc.device)
        cld[NCLDQL] = out.tenl_l.T
        cld[NCLDQI] = out.tenl_i.T
        res = {
            "PLUDE": inputs.plude.T,
            "PCOVPTOT": out.pcovptot,
            "PFPLSL": out.pfplsl,
            "PFPLSN": out.pfplsn,
            "PFHPSL": out.pfhpsl,
            "PFHPSN": out.pfhpsn,
            "TENDENCY_LOC_A": torch.zeros_like(out.tenl_t),
            "TENDENCY_LOC_T": out.tenl_t,
            "TENDENCY_LOC_Q": out.tenl_q,
            "TENDENCY_LOC_CLD": cld.permute(2, 0, 1),
        }
        errors = {
            k: cval.field_errors_torch(k, v, _tile_columns(ref[k], ncol, v),
                                       ngptot=ncol)
            for k, v in res.items()
        }
        if quiet:
            return all(e.passed(threshold) for e in errors.values())
        return cval.print_validation(errors, threshold)

    def write_reference(self, out: Cloudsc2Outputs, path) -> None:
        """WRITE_REFERENCE (…array_state_mod.F90:260-287): the first
        ``klon_file`` columns of the ``(ncol, nlev)`` outputs, in file order,
        as a golden store (``.npz`` or ``.h5``).  The reference requires
        NPROMA == the stored KLON for this (:264-268), so fewer columns are
        refused."""
        from .errors import abor1

        if self.ngptot < self.klon_file:
            abor1(f"write_reference needs >= {self.klon_file} columns, "
                  f"have {self.ngptot}")
        head = type(out)(*(x[: self.klon_file] for x in out))
        res = {k: np.moveaxis(v, 0, -1) for k, v in self.output_dict(head).items()}
        cio.write_reference_h5(path, res)
