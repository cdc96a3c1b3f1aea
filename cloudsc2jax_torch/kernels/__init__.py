"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it, and the nvcc build that compiles them at first use."""
