"""cloudsc2jax_torch — CLOUDSC2 on NVIDIA GPUs with PyTorch and CUDA.

A port of :mod:`cloudsc2jax`, which stays the reference it is tested
against.  It carries the nonlinear main path (input loading and expansion
on the device, the fused SATUR+CLOUDSC2 sweep, golden validation on the
device), the TL+AD work unit, and the standalone TL and AD variants (the
f64 truth path with the Taylor and adjoint tests, and the f32 verdicts
through the kernels), each over one device or a column decomposition over
lanes and processes (:mod:`cloudsc2jax_torch.dist`), and the A/B harness
:mod:`cloudsc2jax_torch.kernel_ab`
over the work unit's schedules (two-kernel, fused single-launch,
int16-encoded streams).  Every sweep is a hand-written CUDA kernel (``csrc/``)
with its plain PyTorch version beside it in
:mod:`cloudsc2jax_torch.kernels`.  The package exports the JAX package's
names (``cloudsc2jax/__init__.py:10-38``), each resolved at its first use
(PEP 562), so importing the package loads no physics and never JAX.
"""

import importlib

__version__ = "0.1.0"

# exported name -> the submodule that defines it
_EXPORTS = {
    **{name: "constants" for name in (
        "NCLV", "NCLDQL", "NCLDQI", "NCLDQR", "NCLDQS", "NCLDQV",
        "Params", "Yomcst", "Yoethf", "Yrecldp", "Yrephli", "Yophnc", "Yomncl")},
    "Cloudsc2Inputs": "physics.cloudsc2",
    "Cloudsc2Outputs": "physics.cloudsc2",
    "cloudsc2": "physics.cloudsc2",
    "cuadjtqs": "physics.cuadjtqs",
    "satur": "physics.satur",
    "cloudsc2_tl": "tlad",
    "cloudsc2_ad": "tlad",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{module}", __name__), name)
