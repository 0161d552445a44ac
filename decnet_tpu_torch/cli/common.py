"""Shared CLI plumbing — the port of decnet_tpu/cli/common.py: the config
flags (the reference's own names among them), the checkpoint's config
sidecar, and the model built and filled from a checkpoint.

A checkpoint (`--resume`) is any of:
  * a directory with `params.npz` (and `meta.json` with its step), as the
    JAX package's `scripts/export_ckpt.py` and the port write it, or a
    `.npz` file;
  * a port training directory (`train/checkpoint.py::CheckpointManager`):
    its newest step's parameters (the train CLI resumes the optimizer and
    step too);
  * a reference `.pkl` torch checkpoint (`train/torch_import.py`).
An Orbax directory of the JAX package is refused with a message."""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional, Tuple

import torch

from decnet_tpu_torch.config import Config, load_config, load_full_config
from decnet_tpu_torch.device import resolve_device
from decnet_tpu_torch.models.decnet import DecNet
from decnet_tpu_torch.train.checkpoint import (PARAMS_FILE, CheckpointManager,
                                               load_torch_checkpoint)
from decnet_tpu_torch.weights import load_flax_variables

# the reference's model flags, re-applied over a checkpoint's sidecar
MODEL_FLAGS = ("base_channels", "num_stage", "down_scale", "cost_func",
               "skip_stage_id", "thold")
ARCHS = ("decnet",)


def add_config_args(p: argparse.ArgumentParser):
    p.add_argument("--config", type=str, default=None,
                   help="JSON config file")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="SECTION.KEY=VALUE",
                   help="config override, e.g. --set model.max_disp=192")
    # the reference's flag names
    p.add_argument("--arch", type=str, default=None)
    p.add_argument("--max_disp", type=int, default=None)
    p.add_argument("--base_channels", type=int, default=None)
    p.add_argument("--num_stage", type=int, default=None)
    p.add_argument("--down_scale", type=int, default=None)
    p.add_argument("--cost_func", type=str, default=None)
    p.add_argument("--skip_stage_id", type=int, default=None)
    p.add_argument("--use_detail", type=int, default=None)
    p.add_argument("--thold", type=float, default=None)
    p.add_argument("--down_func_name", type=str, default=None)
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint: a params.npz directory, a port "
                   "training directory or a reference .pkl")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")


def _check_arch(args):
    if args.arch is not None and args.arch not in ARCHS:
        raise ValueError(f"--arch {args.arch!r}: the port has {ARCHS}")


def build_config(args) -> Config:
    """The config file (or the defaults), the reference flags, then the
    `--set` overrides; unported values raise (`config.py`)."""
    _check_arch(args)
    cfg = load_full_config(args.config) if args.config else Config()
    d = cfg.to_dict()
    for name in ("max_disp",) + MODEL_FLAGS:
        v = getattr(args, name, None)
        if v is not None:
            d["model"][name] = v
    if args.use_detail is not None:
        d["model"]["use_detail"] = bool(args.use_detail)
    if args.down_func_name is not None:
        d["loss"]["down_func_name"] = args.down_func_name
    if getattr(args, "seed", None) is not None:
        d["train"]["seed"] = args.seed
    return Config.from_dict(d).apply_overrides(args.overrides)


def _max_disp_given(args) -> bool:
    return (args.max_disp is not None or args.config is not None
            or any(ov.startswith("model.max_disp=")
                   for ov in args.overrides))


def apply_checkpoint_sidecar(cfg: Config, args) -> Config:
    """The checkpoint's `config.json` model section as the architecture,
    with every model flag and `--set model.*` the user passed applied over
    it.  max_disp is a serving knob: the value given by --max_disp, a
    `--set` or --config stays; without one the sidecar's is used (the JAX
    CLI keeps its default, 216, which every committed sidecar holds)."""
    sidecar = args.resume and os.path.join(args.resume, "config.json")
    if not (sidecar and os.path.exists(sidecar)):
        return cfg
    d = cfg.to_dict()
    runtime_max_disp = d["model"]["max_disp"]
    d["model"] = dataclasses.asdict(load_config(sidecar))
    if _max_disp_given(args):
        d["model"]["max_disp"] = runtime_max_disp
    reapplied = []
    for name in MODEL_FLAGS:
        v = getattr(args, name, None)
        if v is not None:
            d["model"][name] = v
            reapplied.append(name)
    if args.use_detail is not None:
        d["model"]["use_detail"] = bool(args.use_detail)
        reapplied.append("use_detail")
    model_ovs = [ov for ov in args.overrides if ov.startswith("model.")]
    cfg = Config.from_dict(d).apply_overrides(model_ovs)
    reapplied.extend(ov.split("=", 1)[0] for ov in model_ovs)
    extra = f" (CLI keeps: {', '.join(reapplied)})" if reapplied else ""
    print(f"model config from {sidecar}{extra}", flush=True)
    return cfg


def _is_orbax(path: str) -> bool:
    """A directory of numbered steps the port did not write."""
    return os.path.isdir(path) and any(
        n.isdigit() and os.path.isdir(os.path.join(path, n))
        for n in os.listdir(path))


def load_snapshot(model: torch.nn.Module, npz: str) -> int:
    """Fill `model` from a params snapshot (`params.npz`, its parameters
    and BN statistics) and return its step, from the `meta.json` beside
    it (0 without one), as decnet_tpu/cli/common.py:115-131 does."""
    load_flax_variables(model, npz)
    step = 0
    meta = os.path.join(os.path.dirname(npz), "meta.json")
    if os.path.exists(meta):
        with open(meta) as f:
            step = int(json.load(f).get("step", 0))
    print(f"Restored params snapshot (step {step}) from {npz}", flush=True)
    return step


def init_model_and_state(cfg: Config, resume: Optional[str] = None,
                         device="cuda") -> Tuple[DecNet, int]:
    """DecNet of `cfg.model` in eval mode on `device` (fresh parameters
    drawn from `train.seed`), filled from `resume` when given (see the
    module's docstring), and the step it was saved at (0 for a fresh
    model or a `.pkl`)."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.train.seed)
        model = DecNet(cfg.model)
    model = model.to(dev).eval()
    step = 0
    if not resume:
        return model, step
    npz = (resume if resume.endswith(".npz")
           else os.path.join(resume, PARAMS_FILE))
    latest = (CheckpointManager(resume).latest_step()
              if os.path.isdir(resume) else None)
    if latest is not None:
        load_flax_variables(model, os.path.join(resume, str(latest),
                                                PARAMS_FILE))
        step = latest
        print(f"Restored checkpoint step {step} from {resume}", flush=True)
    elif os.path.isfile(npz):
        step = load_snapshot(model, npz)
    elif os.path.isfile(resume):
        load_torch_checkpoint(resume, model, cfg.model.num_stage)
    elif _is_orbax(resume):
        raise NotImplementedError(
            f"{resume}: an Orbax checkpoint directory is not read by the "
            f"port; export its params.npz with scripts/export_ckpt.py")
    else:
        print(f"No checkpoint found in {resume}; starting fresh", flush=True)
    return model, step
