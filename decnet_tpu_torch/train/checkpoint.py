"""Parameter snapshots — the port's side of decnet_tpu/train/checkpoint.py
`save_params`/`load_params`: `params.npz` holds the flat flax-named arrays
(params and batch_stats) in the layout of `runs/ckpt_*/params.npz`, with
the run's `config.json` beside it, so that the JAX package's `load_params`
and the port's `weights.load_checkpoint` both read it back."""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from decnet_tpu_torch.config import Config
from decnet_tpu_torch.weights import flax_arrays_from_model


def save_params(ckpt_dir: str, model: torch.nn.Module, cfg: Config) -> str:
    """Write `<ckpt_dir>/params.npz` and `<ckpt_dir>/config.json`; returns
    the npz path.  The npz is written under a temporary name and renamed,
    so a reader never sees half a file."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "params.npz")
    tmp = os.path.join(ckpt_dir, "params.tmp.npz")
    np.savez(tmp, **flax_arrays_from_model(model))
    os.replace(tmp, path)
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump(cfg.to_dict(), f, indent=2)
    return path
