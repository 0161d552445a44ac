"""Tensor operations of the port (NCHW); `kernels/` holds the CUDA kernels
and their plain PyTorch versions."""
