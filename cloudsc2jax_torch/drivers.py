"""Run harnesses: the nonlinear sweep and the TL+AD work unit (reference
``src/cloudsc2_nl/cloudsc_driver_mod.F90`` and
``src/cloudsc2_ad/cloudsc_driver_ad_mod.F90``).

Port of :func:`cloudsc2jax.drivers.run_nl` and of
:func:`cloudsc2jax.drivers.run_tlad` with ``backend="pallas_blocked"``: the
kernels' own levels-major streams, no column padding.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .constants import Params
from .kernels.cloudsc2_kernel import (
    Cloudsc2StreamOutputs,
    cloudsc2_nl,
    unblock_outputs,
)
from .kernels.tlad_kernel import cloudsc2_ad, cloudsc2_tl
from .physics.cloudsc2 import Cloudsc2Inputs, Cloudsc2Outputs

__all__ = ["DSCALE", "run_nl", "run_tlad"]

# the drivers' canonical perturbation scale, dx = DSCALE*x
# (cloudsc_driver_{tl,ad}_mod.F90:156-171): the work unit's increments and
# the CLI's adjoint identity <dx, M^T M dx> use the same value
DSCALE = 0.01


def run_nl(
    inputs: Cloudsc2Inputs,
    params: Params,
    *,
    ldrain1d: bool = False,
) -> Cloudsc2Outputs:
    """Forward (nonlinear) run over all columns
    (cloudsc_driver_mod.F90:73-119): the SATUR+CLOUDSC2 sweep on levels-major
    inputs — the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors — returned as the ``(ncol, nlev)`` contract."""
    return unblock_outputs(cloudsc2_nl(inputs, params, ldrain1d=ldrain1d), params)


def run_tlad(
    inputs: Cloudsc2Inputs,
    params: Params,
    *,
    lregcl: bool = True,
    ldrain1d: bool = False,
    write_primal: bool = True,
) -> Tuple[Optional[Cloudsc2StreamOutputs], Cloudsc2StreamOutputs, Cloudsc2Inputs]:
    """One TL+AD sweep, the production 4D-Var work unit
    (cloudsc_driver_ad_mod.F90:158-237).

    ``inputs`` are levels-major with ``pqs`` (``device_kernel_inputs(...,
    pqs=True)``).  The TL sweep propagates the canonical ``DSCALE·x``
    increments, formed in registers, and writes the 3 carry checkpoints;
    the reverse sweep pulls the tangent image back from them.  Returns
    ``(outputs | None, d_outputs, input_adjoints)``: the 8 levels-major
    primal streams (``None`` with ``write_primal=False``, the reference AD
    driver's contract), the 8 tangent streams, and the levels-major
    adjoints of the 16 inputs — the counterparts of the JAX blocked
    contract.  CUDA tensors run the kernels, CPU tensors their plain
    versions.
    """
    out, dout, ckpts = cloudsc2_tl(inputs, params, dscale=DSCALE, lregcl=lregcl,
                                   ldrain1d=ldrain1d, write_primal=write_primal)
    adj = cloudsc2_ad(inputs, dout, ckpts, params, lregcl=lregcl,
                      ldrain1d=ldrain1d)
    return out, dout, adj
