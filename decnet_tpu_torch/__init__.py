"""DecNet in PyTorch for an NVIDIA H100: the port of `decnet_tpu`.

`decnet_tpu/` (JAX, Flax, Pallas for a TPU) is the reference; this package
computes the same functions in PyTorch, with the TPU kernels on its path
rewritten by hand in CUDA C++ for Hopper (`csrc/`).  It imports nothing of
JAX or of `decnet_tpu`.

Conventions:
  * layout is NCHW (volumes NCDHW), the kernels take NCHW too;
  * entry points take an explicit `device`, default "cuda", and raise when
    no card is present rather than falling back to the CPU;
  * a kernel wrapper launches its CUDA kernel for a CUDA tensor (or
    raises) and runs the kernel's plain PyTorch version for a CPU tensor.
"""

__version__ = "0.1.0"
