"""cloudsc2jax_torch — CLOUDSC2 on one NVIDIA GPU with PyTorch and CUDA.

A port of :mod:`cloudsc2jax`, which stays the reference it is tested
against.  This slice carries the nonlinear main path: input loading and
expansion on the device, the fused SATUR+CLOUDSC2 sweep as a hand-written
CUDA kernel (``csrc/cloudsc2_nl.cu``, with its plain PyTorch version in
:mod:`cloudsc2jax_torch.kernels.cloudsc2_kernel`), and golden validation
on the device.  Importing the package loads no physics and never JAX;
import the submodules you need.
"""

__version__ = "0.1.0"
