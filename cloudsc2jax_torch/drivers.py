"""Run harnesses: the nonlinear sweep, the TL+AD work unit, the Taylor test
and the adjoint symmetry test (reference
``src/cloudsc2_nl/cloudsc_driver_mod.F90``,
``src/cloudsc2_tl/cloudsc_driver_tl_mod.F90`` and
``src/cloudsc2_ad/cloudsc_driver_ad_mod.F90``).

Port of :func:`cloudsc2jax.drivers.run_nl`, ``run_tlad``, ``taylor_test``
and ``adjoint_test``.
"""

from __future__ import annotations

import dataclasses
import sys
from functools import partial

import numpy as np
import torch

from .constants import Params
from .kernels.cloudsc2_kernel import cloudsc2_nl, kernel_prelude, unblock_outputs
from .kernels.tlad_kernel import (
    cloudsc2_ad,
    cloudsc2_kernel_ad,
    cloudsc2_kernel_tl,
    cloudsc2_tl,
    to_levels_major,
)
from .physics.cloudsc2 import Cloudsc2Inputs, cloudsc2

__all__ = ["DSCALE", "AdjointResult", "TaylorResult", "adjoint_test", "run_nl",
           "run_tlad", "taylor_test"]

# the drivers' canonical perturbation scale, dx = DSCALE*x
# (cloudsc_driver_{tl,ad}_mod.F90:156-171): the work unit's increments and
# the CLI's adjoint identity <dx, M^T M dx> use the same value
DSCALE = 0.01


def run_nl(
    inputs: Cloudsc2Inputs,
    params: Params,
    *,
    ldrain1d: bool = False,
    backend: str = "streams",
):
    """Forward (nonlinear) run over all columns
    (cloudsc_driver_mod.F90:73-119).  CUDA tensors run the kernel, CPU
    tensors its plain version.

    ``backend`` (the JAX package's name in brackets):

    * ``"streams"`` [``"pallas_blocked"``], the default and the main path:
      levels-major inputs (``device_kernel_inputs``) through the fused
      SATUR+CLOUDSC2 sweep; returns its 8 levels-major streams
      (``Cloudsc2StreamOutputs``).  A caller that needs the ``(ncol,
      nlev)`` contract assembles it once with
      :func:`~cloudsc2jax_torch.kernels.cloudsc2_kernel.unblock_outputs`,
      as the CLI does before validating.
    * ``"kernels"`` [``"pallas"``]: the standard ``(ncol, nlev)`` contract
      in and out, through the same sweep; the inputs are made levels-major
      once (no copy for transposed views of levels-major tensors, as
      ``state.device_inputs`` builds them).
    * ``"truth"`` [``"xla"``]: :func:`~cloudsc2jax_torch.physics.cloudsc2.
      cloudsc2` on the standard contract, the level loop in PyTorch.
    """
    if backend == "streams":
        return cloudsc2_nl(inputs, params, ldrain1d=ldrain1d)
    if backend == "kernels":
        lm = to_levels_major(inputs._replace(pqs=None))
        return unblock_outputs(cloudsc2_nl(lm, params, ldrain1d=ldrain1d), params)
    if backend == "truth":
        return cloudsc2(inputs, params, ldrain1d=ldrain1d)
    raise ValueError(f"backend must be 'streams', 'kernels' or 'truth', "
                     f"not {backend!r}")


def run_tlad(
    inputs: Cloudsc2Inputs,
    params: Params,
    *,
    lregcl: bool = True,
    ldrain1d: bool = False,
    write_primal: bool = True,
    backend: str = "streams",
):
    """One TL+AD sweep, the production 4D-Var work unit
    (cloudsc_driver_ad_mod.F90:158-237): the canonical ``DSCALE·x``
    increments go through the tangent-linear, and the resulting output
    perturbations come back through the adjoint.  Returns ``(outputs,
    d_outputs, input_adjoints)``.  CUDA tensors run the kernels, CPU tensors
    their plain versions.

    ``backend`` (the JAX package's name in brackets):

    Both kernel backends compute :func:`kernel_prelude` once per unit and
    hand it to both sweeps.

    * ``"streams"`` [``"pallas_blocked"``], the default: ``inputs`` are
      levels-major with ``pqs`` (``device_kernel_inputs(..., pqs=True)``).
      The TL sweep forms the increments in registers and writes the 3 carry
      checkpoints; the reverse sweep pulls the tangent image back from
      them.  Results are the 8 levels-major primal streams (``None`` with
      ``write_primal=False``, the reference AD driver's contract), the 8
      tangent streams, and the levels-major adjoints of the 16 inputs.
    * ``"kernels"`` [``"pallas"``]: the standard contract through the
      kernels.  ``inputs`` are ``(ncol, nlev)``; the increments are
      streamed, the adjoint runs its own checkpointing forward sweep and is
      seeded with the 10-field tangent.  Results are two
      :class:`Cloudsc2Outputs` and a ``(ncol, nlev)``
      :class:`Cloudsc2Inputs`.  The inputs are transposed to levels-major
      once for both sweeps.
    * ``"truth"`` [``"xla"``]: ``torch.func.jvp``/``vjp`` of
      :func:`~cloudsc2jax_torch.physics.cloudsc2.cloudsc2`, the f64
      validation path, same contract as ``"kernels"``.
    """
    if not write_primal and backend != "streams":
        raise ValueError("write_primal=False requires backend='streams' "
                         f"(got {backend!r})")
    if backend == "streams":
        pre = kernel_prelude(inputs, params)
        out, dout, ckpts = cloudsc2_tl(inputs, params, dscale=DSCALE, lregcl=lregcl,
                                       ldrain1d=ldrain1d, write_primal=write_primal,
                                       pre=pre)
        adj = cloudsc2_ad(inputs, dout, ckpts, params, lregcl=lregcl,
                          ldrain1d=ldrain1d, pre=pre)
        return out, dout, adj
    if backend == "kernels":
        lm = to_levels_major(inputs)
        d_lm = Cloudsc2Inputs(*(DSCALE * x for x in lm))
        kw = dict(lregcl=lregcl, ldrain1d=ldrain1d, levels_major=True,
                  pre=kernel_prelude(lm, params))
        out, dout = cloudsc2_kernel_tl(lm, d_lm, params, **kw)
        _, adj = cloudsc2_kernel_ad(lm, dout, params, **kw)
        return tuple(type(t)(*(x.T for x in t)) for t in (out, dout, adj))
    if backend == "truth":
        f = partial(cloudsc2, params=params, lregcl=lregcl, ldrain1d=ldrain1d)
        d_inputs = Cloudsc2Inputs(*(DSCALE * x for x in inputs))
        out, dout = torch.func.jvp(f, (inputs,), (d_inputs,))
        _, vjp_fn = torch.func.vjp(f, inputs)
        (adj,) = vjp_fn(dout)
        return out, dout, adj
    raise ValueError(f"backend must be 'streams', 'kernels' or 'truth', "
                     f"not {backend!r}")


# ------------------------------------------------------------------ Taylor
@dataclasses.dataclass
class TaylorResult:
    norms: np.ndarray  # ZNORMG(10): max over blocks of the mean error ratio
    istart: int  # first lambda index (1-based) with |1-norm|<0.5
    penalty: int  # ITEST penalty
    passed: bool

    def report(self, file=None):
        file = file or sys.stderr
        print(" TL Taylor test ", file=file)
        print("                Lambda   Result", file=file)
        for i, v in enumerate(self.norms):
            print(f" {i+1:4d}  {v:22.14f}", file=file)
        print("   ==============================================   ", file=file)
        if self.passed:
            print(f"       TEST PASSED, penalty {self.penalty}", file=file)
        else:
            print(f"       TEST FAILED, err {self.penalty}", file=file)
        print("   ==============================================   ", file=file)


def _perturbations(inputs: Cloudsc2Inputs, zero_supsat: bool) -> Cloudsc2Inputs:
    """The reference harnesses' canonical increments: 0.01·x for all 16 inputs
    (cloudsc_driver_tl_mod.F90:156-171); the AD driver zeroes the obsolete
    supersaturation perturbation (cloudsc_driver_ad_mod.F90:139)."""
    d = Cloudsc2Inputs(*(DSCALE * x for x in inputs))
    if zero_supsat:
        d = d._replace(psupsat=torch.zeros_like(d.psupsat))
    return d


def _block_sums(field_minus_ref: torch.Tensor, nproma: int) -> torch.Tensor:
    """Sum (ncol, nlev…) tensors over the level axis and nproma-sized
    column blocks -> (nblocks,)."""
    ncol = field_minus_ref.shape[0]
    flat = field_minus_ref.reshape(ncol, -1).sum(dim=1)
    nblocks = -(-ncol // nproma)
    pad = nblocks * nproma - ncol
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(nblocks, nproma).sum(dim=1)


def taylor_test(
    inputs: Cloudsc2Inputs,
    params: Params,
    *,
    nproma: int = 1,
    lregcl: bool = False,
    ldrain1d: bool = False,
) -> TaylorResult:
    """The TL Taylor/gradient test (cloudsc_driver_tl_mod.F90:126-311), on
    the truth path and the inputs' device.

    For λ = 10⁻¹ … 10⁻¹⁰ compares the nonlinear difference against λ·TL:
    for every NPROMA block and each of the 10 output fields with a
    non-negligible TL sum, accumulates |Σ(NL(x+λδx)−NL(x)) / Σ(λ·TLδx)|;
    the per-block mean must converge to 1 with a V-shaped error curve.
    The reference runs this with NPROMA=1 (per-column statistics), the
    default here.
    """
    f = partial(cloudsc2, params=params, lregcl=lregcl, ldrain1d=ldrain1d)
    d_inputs = _perturbations(inputs, zero_supsat=False)

    base, d_out = torch.func.jvp(f, (inputs,), (d_inputs,))

    eps = float(torch.finfo(base.tenl_t.dtype).eps)

    def norms_for(lam):
        pert = f(Cloudsc2Inputs(*(x + lam * dx for x, dx in zip(inputs, d_inputs))))
        znorm = 0.0
        zcount = 0.0
        for fld in range(len(base)):
            num = _block_sums(pert[fld] - base[fld], nproma)
            den = _block_sums(d_out[fld] * lam, nproma)
            active = den.abs() > eps
            den_safe = torch.where(active, den, 1.0)
            znorm = znorm + torch.where(active, (num / den_safe).abs(), 0.0)
            zcount = zcount + active.to(num.dtype)
        # mean over active fields per block, max over blocks
        # (reduction(max:znormg), cloudsc_driver_tl_mod.F90:125,251)
        any_active = zcount > 0
        ratio = torch.where(any_active,
                            znorm / torch.where(any_active, zcount, 1.0), 0.0)
        return ratio.max()

    norms = np.array([float(norms_for(10.0 ** -(i + 1))) for i in range(10)])

    # evaluation (cloudsc_driver_tl_mod.F90:272-311)
    err = np.abs(1.0 - norms)
    istart = 0
    for i in range(10):
        if err[i] < 0.5:
            istart = i + 1
            break
    if istart == 0 or istart > 4:
        return TaylorResult(norms=norms, istart=istart, penalty=13, passed=False)
    itest = -10
    inegat = 1
    for i in range(istart - 1, 9):
        itempnegat = 1 if err[i + 1] / err[i] < 1.0 else 0
        if inegat > itempnegat:
            itest += 10
        inegat = itempnegat
    if itest == -10:
        itest = 11  # no change of sign at all
    if err[istart - 1 : 10].min() > 1.0e-5:
        itest += 7  # hard limit
    if err[istart - 1 : 10].min() > 1.0e-6:
        itest += 5  # soft limit
    return TaylorResult(norms=norms, istart=istart, penalty=itest, passed=itest <= 5)


# ----------------------------------------------------------------- Adjoint
@dataclasses.dataclass
class AdjointResult:
    max_error: float  # in units of the working precision's machine epsilon
    passed: bool

    def report(self, file=None):
        file = file or sys.stderr
        print(" AD TEST ", file=file)
        print(
            f" The maximum error is {self.max_error:.6f}"
            " times the zero of the machine. ",
            file=file,
        )
        print("   =============================  ", file=file)
        print(
            "   =           TEST OK         = "
            if self.passed
            else "   =        TEST FAILED        = ",
            file=file,
        )
        print("   =============================  ", file=file)


def adjoint_test(
    inputs: Cloudsc2Inputs,
    params: Params,
    *,
    lregcl: bool = True,
    ldrain1d: bool = False,
    threshold: float = 1.0e4,
) -> AdjointResult:
    """Adjoint symmetry test ⟨Mδx, Mδx⟩ = ⟨δx, MᵀMδx⟩ per column
    (cloudsc_driver_ad_mod.F90:110-293) on the truth path, with LREGCL
    active as in the AD entry program (cloudsc2_ad/dwarf_cloudsc.F90:105)."""
    f = partial(cloudsc2, params=params, lregcl=lregcl, ldrain1d=ldrain1d)
    d_inputs = _perturbations(inputs, zero_supsat=True)
    # machine epsilon of the WORKING precision: the reference compares
    # against EPSILON(1.0_JPRB) (cloudsc_driver_ad_mod.F90:258), which is
    # eps32 under -DSINGLE, so an f32 run must be judged in f32 units
    eps = float(torch.finfo(inputs.pt.dtype).eps)

    _, d_out = torch.func.jvp(f, (inputs,), (d_inputs,))
    norm1 = sum((y ** 2).reshape(y.shape[0], -1).sum(dim=1) for y in d_out)
    _, vjp_fn = torch.func.vjp(f, inputs)
    (adj,) = vjp_fn(d_out)
    norm2 = sum((a * b).reshape(a.shape[0], -1).sum(dim=1)
                for a, b in zip(d_inputs, adj))
    # per-column error in machine epsilons; only the max reaches the host
    norm3 = (norm1 - norm2).abs() / eps
    norm3 = torch.where(
        norm2 != 0.0,
        norm3 / torch.where(norm2 != 0.0, norm2.abs(), 1.0),
        norm3,
    )
    max_err = float(norm3.max())
    return AdjointResult(max_error=max_err, passed=max_err < threshold)
