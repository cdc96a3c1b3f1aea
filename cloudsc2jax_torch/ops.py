"""Differentiation-control ops.

Port of :mod:`cloudsc2jax.ops`.  Under the LREGCL switch
(yomncl.F90:24-29) the reference damps selected perturbation paths of its
hand-written tangent-linear and adjoint without touching the nonlinear
trajectory (cloudsc2tl.F90:323-324, 574-580, 657, 994-1001; mirrored in
cloudsc2ad.F90).  Here the one nonlinear level body is differentiated with
``torch.func.jvp``/``torch.func.vjp``, and each damp is an identity op whose
tangent and cotangent are scaled by the same factor, so TL and AD stay
mutually adjoint by construction.

:func:`power` is the one op here that is not about derivatives: a power
whose value does not depend on where an element sits in its tensor.
"""

from __future__ import annotations

import torch

__all__ = ["damp_tangent", "maximum", "minimum", "power"]


class _DampTangent(torch.autograd.Function):
    """Identity on the primal; tangent and cotangent times ``factor``."""

    @staticmethod
    def forward(x, factor):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, factor = inputs
        if isinstance(factor, torch.Tensor):
            ctx.save_for_forward(factor)
            ctx.save_for_backward(factor)
            ctx.factor = None
        else:
            ctx.factor = factor

    @staticmethod
    def jvp(ctx, dx, dfactor):
        factor = ctx.factor if ctx.factor is not None else ctx.saved_tensors[0]
        return dx * factor

    @staticmethod
    def backward(ctx, g):
        factor = ctx.factor if ctx.factor is not None else ctx.saved_tensors[0]
        return g * factor, None


def damp_tangent(x: torch.Tensor, factor) -> torch.Tensor:
    """Identity on the primal; scales the tangent (and, transposed, the
    cotangent) of ``x`` by ``factor``.

    ``factor`` (a tensor or a Python float) is trajectory data: it gets no
    gradient, as the reference TL computes its ZYYY damp from the ``*5``
    trajectory variables only.  Works under ``torch.func.jvp`` and
    ``torch.func.vjp``.
    """
    return _DampTangent.apply(x, factor)


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum``: NaN-propagating max whose tangent and cotangent
    select the larger operand's and split an exact tie evenly.
    ``torch.maximum`` has the same values and cotangents, but its tangent
    is ``b_t + w*(a_t - b_t)``, which rounds away the low bits of the
    selected tangent when the other one is larger."""
    return torch.where(a > b, a, torch.where(a < b, b, (a + b) * 0.5))


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum``, as :func:`maximum`."""
    return torch.where(a < b, a, torch.where(a > b, b, (a + b) * 0.5))


def power(x: torch.Tensor, exponent: float) -> torch.Tensor:
    """``x ** exponent``, the same value for the same element at every
    position of ``x``.  On the CPU, float32 ``torch.pow`` with a non-integer
    exponent rounds the elements of its vectorised loop and those of its
    tail differently (an ulp apart for equal inputs), so there a float32
    tensor is raised in float64 and rounded once, its tangent and cotangent
    too.  Any other tensor is raised as ``x ** exponent``: the float64
    traces of the level bodies, and so the generated CUDA, are unchanged."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return (x.double() ** exponent).float()
    return x ** exponent
