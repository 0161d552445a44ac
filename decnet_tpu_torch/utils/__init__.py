"""Visualisation and profiling helpers (decnet_tpu/utils/)."""
