"""Hand-written CUDA kernels (sources in decnet_tpu_torch/csrc/), their
ctypes wrappers and their plain PyTorch versions."""
