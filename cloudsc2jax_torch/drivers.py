"""Run harness for the nonlinear sweep (reference
``src/cloudsc2_nl/cloudsc_driver_mod.F90``).

Port of :func:`cloudsc2jax.drivers.run_nl`; the TL/AD harnesses come with
a later slice of the port.
"""

from __future__ import annotations

from .constants import Params
from .kernels.cloudsc2_kernel import cloudsc2_nl, unblock_outputs
from .physics.cloudsc2 import Cloudsc2Inputs, Cloudsc2Outputs

__all__ = ["run_nl"]


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
