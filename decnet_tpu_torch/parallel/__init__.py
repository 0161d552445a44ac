"""Data-parallel training across processes (decnet_tpu/parallel/)."""
