"""Checkpoints — the port's side of decnet_tpu/train/checkpoint.py.

`save_params`/`load_params`' twin: `params.npz` holds the flat flax-named
arrays (params and batch_stats) in the layout of `runs/ckpt_*/params.npz`,
with the run's `config.json` beside it, so that the JAX package's
`load_params` and the port's `weights.load_checkpoint` both read it back.

`CheckpointManager` is the twin of the JAX package's Orbax manager: a
resumable train state per saved step, `<dir>/<step>/params.npz` (as above)
and `<dir>/<step>/train_state.pt` (the optimizer's state_dict, the step and
the step its schedule started at), the newest `keep` of them kept.  Every save also refreshes
`<dir>/params.npz` and `<dir>/config.json`, the run's newest weights for
serving.  An Orbax directory is not read.

`load_torch_checkpoint` imports a reference `.pkl` checkpoint
(`train/torch_import.py`)."""
from __future__ import annotations

import json
import os
import shutil
from typing import List, Optional

import numpy as np
import torch

from decnet_tpu_torch.config import Config
from decnet_tpu_torch.train import torch_import
from decnet_tpu_torch.weights import flax_arrays_from_model, load_flax_variables

PARAMS_FILE = "params.npz"
STATE_FILE = "train_state.pt"


def save_params(ckpt_dir: str, model: torch.nn.Module, cfg: Config) -> str:
    """Write `<ckpt_dir>/params.npz` and `<ckpt_dir>/config.json`; returns
    the npz path.  The npz is written under a temporary name and renamed,
    so a reader never sees half a file."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, PARAMS_FILE)
    tmp = os.path.join(ckpt_dir, "params.tmp.npz")
    np.savez(tmp, **flax_arrays_from_model(model))
    os.replace(tmp, path)
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump(cfg.to_dict(), f, indent=2)
    return path


class CheckpointManager:
    """Save, list and restore the train state (`train.step.TrainState`:
    model parameters and BN statistics, optimizer state, step)."""

    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep

    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.directory, n, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state, cfg: Config) -> str:
        """Write the state at its step (written into a temporary directory,
        then renamed; a step saved before is replaced), drop all but the
        newest `keep` steps, refresh the serving snapshot.  Returns the
        step's directory."""
        os.makedirs(self.directory, exist_ok=True)
        final = self._dir(state.step)
        tmp = os.path.join(self.directory, f".{state.step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, PARAMS_FILE),
                 **flax_arrays_from_model(state.model))
        torch.save({"step": state.step,
                    "schedule_from": state.schedule_from,
                    "optimizer": state.optimizer.state_dict()},
                   os.path.join(tmp, STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.steps()[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._dir(old), ignore_errors=True)
        save_params(self.directory, state.model, cfg)
        return final

    def restore(self, state):
        """Bring back the parameters, BN statistics, optimizer state and
        step of the newest saved step into `state`, in place; returns it."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = self._dir(step)
        load_flax_variables(state.model, os.path.join(d, PARAMS_FILE))
        # the optimizer moves its moments to its parameters' device; the
        # step counts stay on the host, as a fresh optimizer keeps them
        saved = torch.load(os.path.join(d, STATE_FILE), map_location="cpu",
                           weights_only=True)
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])
        state.schedule_from = int(saved.get("schedule_from", 0))
        return state


def load_torch_checkpoint(path: str, model: torch.nn.Module,
                          num_stage: int = 4) -> dict:
    """Fill `model` from a reference `.pkl` torch checkpoint; returns the
    import report (copied / missing / unmatched), which it also prints."""
    return torch_import.load_reference_checkpoint(path, model, num_stage)
