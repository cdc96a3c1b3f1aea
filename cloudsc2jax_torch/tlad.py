"""Tangent-linear and adjoint of CLOUDSC2 by PyTorch autodiff: the truth path.

Port of :mod:`cloudsc2jax.tlad`.  Both operators derive from the single
nonlinear source :func:`cloudsc2jax_torch.physics.cloudsc2.cloudsc2` with
``torch.func.jvp`` / ``torch.func.vjp``.  The LREGCL perturbation
regularisations live inside the NL code
(:func:`cloudsc2jax_torch.ops.damp_tangent`), so ``lregcl=True`` gives the
regularised operator pair (the adjoint symmetry test, as the reference's AD
entry program sets it, cloudsc2_ad/dwarf_cloudsc.F90:105) and
``lregcl=False`` the exact one (the Taylor test,
cloudsc2_tl/dwarf_cloudsc.F90:103-104).

This is the f64 validation path: an eager loop over levels, thousands of
small launches per evaluation.  The f32 performance path is the
hand-written kernels, :func:`cloudsc2jax_torch.kernels.tlad_kernel.
cloudsc2_kernel_tl` / ``cloudsc2_kernel_ad``, which are drop-ins for the
functions here.  ``remat`` (checkpointing the level body) is not ported.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import torch

from .constants import Params
from .physics.cloudsc2 import Cloudsc2Inputs, Cloudsc2Outputs, cloudsc2

__all__ = ["cloudsc2_tl", "cloudsc2_ad", "cloudsc2_vjp"]


def cloudsc2_tl(
    inputs: Cloudsc2Inputs,
    d_inputs: Cloudsc2Inputs,
    params: Params,
    *,
    lregcl: bool = False,
    ldrain1d: bool = False,
) -> Tuple[Cloudsc2Outputs, Cloudsc2Outputs]:
    """Tangent-linear CLOUDSC2: returns (outputs, d_outputs).

    Functional equivalent of CLOUDSC2TL (cloudsc2tl.F90:10-24): the
    trajectory is recomputed alongside the linear propagation, one level
    sweep, no stored trajectory.
    """
    f = partial(cloudsc2, params=params, lregcl=lregcl, ldrain1d=ldrain1d)
    return torch.func.jvp(f, (inputs,), (d_inputs,))


def cloudsc2_vjp(
    inputs: Cloudsc2Inputs,
    params: Params,
    *,
    lregcl: bool = False,
    ldrain1d: bool = False,
):
    """Linearise once, transpose many: returns (outputs, vjp_fn).  The
    forward trajectory is stored, like the reference AD's
    checkpoint-everything strategy (cloudsc2ad.F90:228-292)."""
    f = partial(cloudsc2, params=params, lregcl=lregcl, ldrain1d=ldrain1d)
    return torch.func.vjp(f, inputs)


def cloudsc2_ad(
    inputs: Cloudsc2Inputs,
    d_outputs: Cloudsc2Outputs,
    params: Params,
    *,
    lregcl: bool = True,
    ldrain1d: bool = False,
) -> Tuple[Cloudsc2Outputs, Cloudsc2Inputs]:
    """Adjoint CLOUDSC2: returns (outputs, input_adjoints).

    Functional equivalent of CLOUDSC2AD (cloudsc2ad.F90:177-202) seeded
    with output adjoints ``d_outputs``; input adjoints are returned rather
    than accumulated in place.  Unlike the reference's PSUPSAT quirk
    (cloudsc2ad.F90:1733 scales the supersaturation adjoint by PTSPHY and
    overwrites instead of accumulating, harmless there because the AD
    driver zeroes that perturbation, cloudsc_driver_ad_mod.F90:139), this
    adjoint is the exact transpose of the (regularised) tangent operator.
    """
    outputs, vjp_fn = cloudsc2_vjp(inputs, params, lregcl=lregcl,
                                   ldrain1d=ldrain1d)
    (d_in,) = vjp_fn(d_outputs)
    return outputs, d_in
