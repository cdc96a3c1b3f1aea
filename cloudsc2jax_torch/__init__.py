"""cloudsc2jax_torch — CLOUDSC2 on one NVIDIA GPU with PyTorch and CUDA.

A port of :mod:`cloudsc2jax`, which stays the reference it is tested
against.  It carries the nonlinear main path (input loading and expansion
on the device, the fused SATUR+CLOUDSC2 sweep, golden validation on the
device), the TL+AD work unit, and the standalone TL and AD variants (the
f64 truth path with the Taylor and adjoint tests, and the f32 verdicts
through the kernels), and the A/B harness :mod:`cloudsc2jax_torch.kernel_ab`
over the work unit's schedules (two-kernel, fused single-launch,
int16-encoded streams).  Every sweep is a hand-written CUDA kernel (``csrc/``)
with its plain PyTorch version beside it in
:mod:`cloudsc2jax_torch.kernels`.  Importing the package loads no physics and never JAX;
import the submodules you need.
"""

__version__ = "0.1.0"
