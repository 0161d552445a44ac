"""Training CLI — the port of decnet_tpu/cli/train.py.

Any committed checkpoint's recipe trains: the faithful model, learned
detail heads (`use_detail`, whose mask loss adds `loss.alpha` times its
value), the s2d stages (`s2d_fine`, `s2d_stages` 1 or 2) and the
windowed matching (`match_window`), under any of the five loss types.
The config is the JAX CLI's: `--config` (JSON, or YAML when PyYAML
imports), the reference's flags (`--max_disp`, `--use_detail`, `--seed`,
...; `cli/common.py::add_config_args`), then the `--set` overrides.

Data: with `data.on_device` (`--dataset synthetic`) batches are made on
the device (`data/device_synth.py`).  Otherwise (`--set
data.on_device=false`, the JAX CLI's default) they come from files: the
dataset `--dataset` under `--root` (sceneflow, kitti15, middlebury,
drivingstereo, or the host `synthetic`; `--train_split`, `--mask_source`,
`--dataset_length` for synthetic), cropped and augmented by
`data/datasets.py` in `data.num_workers` loader threads that keep batches
ready ahead of the step, epoch after epoch, and a thread that pins each
batch ahead so the step only enqueues its copy to the card
(`data/loader.py::device_batches`).  With --eval_split the
dataset's eval batches go to the device once, at the start.

Per step: the forward with batch-statistic batch norm (running
statistics from `train.freeze_bn_after` on, or throughout with
`train.freeze_bn`), the loss, backward, the global-norm clip and Adam at
the scheduled rate.  With `train.packed_exec` a faithful model's
frozen-BN steps run its packed s2d twin (s2d_stages 2) on its own
parameters gathered (`models/repack.py::repack_linear`): the gradients
land on the faithful parameters, which the optimizer and checkpoints
keep.  Logs the JAX CLI's JSON lines every
`train.log_every` steps, with `loader_wait_s`, the host's seconds spent
waiting for batches in that interval (and eval lines with --eval_split).
Every `train.ckpt_every` steps and at the end it saves a resumable
checkpoint, `<ckpt_dir>/<step>/` (the newest `train.keep_ckpts` kept), and
refreshes `<ckpt_dir>/params.npz` and `config.json`.

Across processes (`--multihost 1`, or whenever the torchrun variables
RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT are set, as the JAX CLI
joins its cluster when JAX_COORDINATOR_ADDRESS is): one process per card
(`parallel/mesh.py::init_distributed`: nccl, or `--dist_backend gloo`,
which also lets two processes share one card).  `train.batch_size` is the
global batch.  The processes form the mesh `mesh.data x mesh.tile x
mesh.disp` (`--set mesh.tile=2 --set mesh.disp=2`; a world of another size
is refused): each loads `batch_size // data` images of it
(`DataLoader(shard=(data index, data))`) and keeps its rows of them over
tile, and the stage-0 hypotheses split over disp (`parallel/mesh.py`).
The batch statistics, losses, eval metrics and gradients are those of the
global batch, and every process holds the same state (rank 0's, broadcast
after a restore or warm start).  Only rank 0 logs and writes checkpoints.
The on-device stream gives each process its rows of the global draw when
data is 1, and is refused with more than one data rank, as JAX refuses it
across processes.

`train.max_rss_gb` > 0 is the JAX CLI's host memory guard: when a
process's resident set (/proc/self/status) exceeds it at a log step, rank
0 saves a checkpoint and every process exits with code 75, so that a
supervisor restarts and resumes the run.

Usage:
  torchrun --nproc_per_node G -m decnet_tpu_torch.cli.train --multihost 1 \
      --config runs/ckpt_faithful/config.json --dataset sceneflow \
      --root /data/sf --set data.on_device=false --ckpt_dir out/
  torchrun --nproc_per_node 4 -m decnet_tpu_torch.cli.train --multihost 1 \
      --config runs/ckpt_faithful/config.json --dataset synthetic \
      --set mesh.tile=2 --set mesh.disp=2 --ckpt_dir out/ \
      [--dist_backend gloo]
  python -m decnet_tpu_torch.cli.train --config runs/ckpt_faithful/config.json \
      --dataset synthetic --ckpt_dir out/ --steps 100 \
      [--init_from runs/ckpt_faithful] [--set train.batch_size=4 ...] \
      [--eval_split val --eval_every 50 --eval_batches 4] [--device cuda]
  python -m decnet_tpu_torch.cli.train --config runs/ckpt_faithful/config.json \
      --dataset sceneflow --root /data/sf --set data.on_device=false \
      --ckpt_dir out/ --steps 100 [--init_from runs/ckpt_faithful]

A --ckpt_dir that holds a checkpoint is resumed from its newest step:
parameters, BN statistics, optimizer state and step; the on-device stream
goes on at that step's batch (a dataset's loader starts a new epoch, as
the JAX CLI's does).  One that holds only a params snapshot
(`params.npz` + `meta.json`, as every `runs/ckpt_*`) restores its
parameters and BN statistics at its step, with a fresh optimizer whose
schedule starts again, as the JAX CLI does.  --init_from then does
nothing; on a fresh run it
warm-starts from a params.npz directory, as the JAX CLI's
`restore_partial` does from an Orbax directory: every parameter and BN
statistic whose key and shape match is copied, the rest keep their fresh
initialisation, and the optimizer and step start fresh.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import itertools
import json
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from decnet_tpu_torch.cli.common import add_config_args, load_snapshot
from decnet_tpu_torch.cli.common import build_config as common_build_config
from decnet_tpu_torch.config import Config
from decnet_tpu_torch.data import get_dataset
from decnet_tpu_torch.data.device_synth import device_batch_stream
from decnet_tpu_torch.data.loader import (HOST_KEYS, DataLoader,
                                          device_batches, to_device)
from decnet_tpu_torch.device import resolve_device
from decnet_tpu_torch.models.decnet import DecNet
from decnet_tpu_torch.models.repack import repack_linear
from decnet_tpu_torch.parallel import mesh
from decnet_tpu_torch.train.checkpoint import PARAMS_FILE, CheckpointManager
from decnet_tpu_torch.train.step import (TrainState, check_loss_type,
                                         create_train_state, eval_step,
                                         train_step)
from decnet_tpu_torch.weights import warm_start

EVAL_KEYS = ("epe", "d1", "epe_up0", "d1_up0")
RSS_EXIT_CODE = 75          # the JAX CLI's: checkpointed, restart me


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    # --config (JSON or YAML), --set and the reference's flags, as the JAX
    # CLI takes them; --resume is accepted and not read, as there
    add_config_args(p)
    p.add_argument("--dataset", required=True,
                   help="synthetic (on the device with data.on_device, "
                   "else the host twin), sceneflow, kitti15, middlebury, "
                   "drivingstereo")
    p.add_argument("--root", default="",
                   help="the dataset's directory (files only)")
    p.add_argument("--train_split", default="train")
    p.add_argument("--mask_source", default="compute",
                   choices=("compute", "precomputed", "wavelet"))
    p.add_argument("--dataset_length", type=int, default=None,
                   help="the host synthetic dataset's length")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--steps", type=int, default=None,
                   help="train.total_steps (also sets the schedule's length)")
    p.add_argument("--init_from", default=None,
                   help="warm start: a directory with a params.npz; "
                   "what matches by key and shape is loaded")
    p.add_argument("--eval_split", default=None,
                   help="a split of the dataset to evaluate on; any value "
                   "with data.on_device (the validation stream)")
    p.add_argument("--eval_every", type=int, default=2000)
    p.add_argument("--eval_batches", type=int, default=16)
    p.add_argument("--multihost", type=int, default=0,
                   help="join the process group of the torchrun variables "
                   "(also done whenever they are set)")
    p.add_argument("--dist_backend", default=None, choices=("nccl", "gloo"),
                   help="the process group's backend: nccl on the card, "
                   "gloo on the CPU by default; gloo lets processes share "
                   "a card")
    return p.parse_args(argv)


def build_config(args: argparse.Namespace) -> Config:
    """The config as the JAX CLI builds it (`cli/common.py::build_config`:
    the config file, the reference's flags, the `--set` overrides), then
    the dataset, --ckpt_dir and --steps."""
    cfg = common_build_config(args)
    if cfg.data.on_device and args.dataset != "synthetic":
        raise ValueError(f"data.on_device makes synthetic batches; --dataset "
                         f"{args.dataset!r} is read from files with "
                         f"--set data.on_device=false")
    check_loss_type(cfg)
    t = cfg.train
    if t.packed_exec:
        if cfg.model.s2d_fine:
            raise ValueError("packed_exec is for faithful form "
                             "(s2d_fine false)")
        if not (t.freeze_bn or t.freeze_bn_after > 0):
            raise ValueError("packed_exec needs a freeze_bn phase to apply "
                             "to (train.freeze_bn or train.freeze_bn_after)")
    cfg.data.dataset, cfg.data.root = args.dataset, args.root
    if args.ckpt_dir:
        cfg.train.ckpt_dir = args.ckpt_dir
    if args.steps:
        cfg.train.total_steps = args.steps
    return cfg


class Waited:
    """An iterator's items, with the host seconds spent waiting for them
    summed in `waited`."""

    def __init__(self, it: Iterator[Dict]):
        self.it, self.waited = it, 0.0

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        t = time.perf_counter()
        try:
            return next(self.it)
        finally:
            self.waited += time.perf_counter() - t


def host_batches(loader: DataLoader, device) -> Iterator[Dict]:
    """The loader's batches on `device`, epoch after epoch through one
    pool of workers, each pinned and handed over ahead of its step
    (`data/loader.py::device_batches`)."""
    for b in device_batches(loader.repeat(), device):
        for k in HOST_KEYS:
            b.pop(k, None)
        yield b


@dataclasses.dataclass
class Run:
    """What `prepare` builds: the config, the train state, the batch
    stream, the fixed eval batches and the checkpoint manager.  Under a
    process group the stream and eval batches are this process's shard."""
    cfg: Config
    state: TrainState
    stream: Iterator[Dict]
    eval_batches: Optional[List[Dict]]
    eval_every: int
    ckpt: CheckpointManager
    # the packed s2d twin of the faithful model and its gather
    # (`models/repack.py::repack_linear`), with train.packed_exec
    packed: Optional[Tuple] = None

    def freeze_bn(self) -> bool:
        """Whether the next step normalises with the running statistics."""
        t = self.cfg.train
        return t.freeze_bn or (t.freeze_bn_after > 0
                               and self.state.step >= t.freeze_bn_after)

    def step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One update; with packed_exec, a frozen-BN step runs through the
        packed twin, as the JAX CLI's freeze step does."""
        frozen = self.freeze_bn()
        return train_step(self.state, batch, self.cfg, frozen,
                          self.packed if frozen else None)

    def evaluate(self) -> Dict[str, float]:
        ms = [eval_step(self.state.model, b, self.cfg)
              for b in self.eval_batches]
        return {k: float(np.mean([float(m[k]) for m in ms]))
                for k in EVAL_KEYS}


def prepare(argv=None) -> Run:
    args = parse_args(argv)
    cfg = build_config(args)
    if args.multihost or mesh.torchrun_env():
        dev = mesh.init_distributed(args.device, args.dist_backend)
    else:
        dev = resolve_device(args.device)
    m = mesh.make_mesh(cfg.mesh)
    # train.batch_size is the global batch; this process loads its images
    # of it (its rows are cut from them below)
    shard, local_bs = mesh.shard(cfg.train.batch_size)
    if m.data == 1:
        shard = None
    elif cfg.data.on_device:
        raise ValueError("on_device data stream is single-process")
    split = m if m.size > 1 else None
    # the fresh initialisation is drawn from train.seed, as JAX's is
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.train.seed)
        model = DecNet(cfg.model)
    state = create_train_state(model.to(dev), cfg)
    ckpt = CheckpointManager(cfg.train.ckpt_dir, keep=cfg.train.keep_ckpts)
    # the restore and warm-start messages come from rank 0 alone
    quiet = (contextlib.nullcontext() if mesh.is_main()
             else contextlib.redirect_stdout(io.StringIO()))
    with quiet:
        if ckpt.latest_step() is not None:
            ckpt.restore(state)
            print(f"Restored checkpoint step {state.step} from "
                  f"{cfg.train.ckpt_dir}", flush=True)
        elif os.path.isfile(os.path.join(cfg.train.ckpt_dir, PARAMS_FILE)):
            # a params snapshot alone: its weights at its step, the optimizer
            # (and so its schedule) fresh, as JAX's init_model_and_state
            state.step = state.schedule_from = load_snapshot(
                state.model, os.path.join(cfg.train.ckpt_dir, PARAMS_FILE))
        if args.init_from and state.step == 0:
            warm_start(state.model, os.path.join(args.init_from, PARAMS_FILE))
    mesh.broadcast_state(state.model)
    # the repack reads the model's structure only; every packed step
    # gathers the faithful tensors anew
    packed = (repack_linear(state.model, stages=2)
              if cfg.train.packed_exec else None)
    if cfg.data.on_device:
        gen_kw = dict(batch=cfg.train.batch_size, h=cfg.train.crop_h,
                      w=cfg.train.crop_w, max_disp=cfg.model.max_disp,
                      scale=cfg.model.down_scale,
                      levels=cfg.model.num_stage - 1,
                      thold=cfg.data.mask_thold, dtype=cfg.model.torch_dtype,
                      device=dev, variant=cfg.data.variant)
        stream = device_batch_stream(cfg.train.seed, start_step=state.step,
                                     mesh=split, **gen_kw)
        eval_batches = None
        if args.eval_split:
            val = device_batch_stream(cfg.train.seed, val=True, mesh=split,
                                      **gen_kw)
            eval_batches = [next(val) for _ in range(args.eval_batches)]
    else:
        ds_kw = dict(scale=cfg.model.down_scale,
                     levels=cfg.model.num_stage - 1,
                     mask_source=args.mask_source,
                     img_size=(cfg.train.crop_h, cfg.train.crop_w))
        length = ({} if args.dataset_length is None
                  else {"length": args.dataset_length})
        ds = get_dataset(args.dataset, args.root, split=args.train_split,
                         is_training=True, seed=cfg.train.seed, **ds_kw,
                         **length)
        stream = host_batches(DataLoader(
            ds, batch_size=local_bs, shuffle=True,
            num_workers=cfg.data.num_workers, drop_last=True,
            seed=cfg.train.seed, shard=shard), dev)
        if m.tile > 1:
            stream = (mesh.shard_batch(b, m, images=False) for b in stream)
        eval_batches = None
        if args.eval_split:
            # the first eval_batches of one epoch, sent to the device once
            eval_ds = get_dataset(args.dataset, args.root,
                                  split=args.eval_split, is_training=False,
                                  **ds_kw)
            eval_loader = DataLoader(eval_ds, batch_size=local_bs,
                                     num_workers=cfg.data.num_workers,
                                     drop_last=True, shard=shard)
            eval_batches = []
            for b in itertools.islice(eval_loader, args.eval_batches):
                b = to_device(b, dev)
                for k in HOST_KEYS:
                    b.pop(k, None)
                eval_batches.append(mesh.shard_batch(b, m, images=False))
    return Run(cfg, state, stream, eval_batches, args.eval_every, ckpt,
               packed)


def rss_gb() -> float:
    """This process's resident set in GB (10^9 bytes), from
    /proc/self/status (VmRSS, in kB)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1e3 / 1e9
    raise RuntimeError("/proc/self/status has no VmRSS line")


def run(r: Run) -> None:
    cfg, t = r.cfg, r.cfg.train
    rank0 = mesh.is_main()
    say = (lambda msg: print(msg, flush=True)) if rank0 else (lambda msg: None)
    dev = next(r.state.model.parameters()).device
    say(f"training from step {r.state.step} to {t.total_steps} "
        f"(device {dev}, mesh {mesh.make_mesh(cfg.mesh).shape}, "
        f"data={'on-device' if cfg.data.on_device else cfg.data.dataset})")
    t_log = time.perf_counter()
    stream, waited = Waited(r.stream), 0.0
    for batch in itertools.islice(stream,
                                  max(t.total_steps - r.state.step, 0)):
        logs = r.step(batch)
        step = r.state.step
        if step % t.log_every == 0:
            logs = {k: float(v) for k, v in logs.items()}
            dt = time.perf_counter() - t_log
            t_log = time.perf_counter()
            waited, wait_s = stream.waited, stream.waited - waited
            say(json.dumps(
                {"step": step, "loss": round(logs["total"], 5),
                 "grad_norm": round(logs["grad_norm"], 4),
                 "steps_per_sec": round(t.log_every / dt, 3),
                 "loader_wait_s": round(wait_s, 4),
                 **{k: round(v, 5) for k, v in logs.items()
                    if k not in ("total", "grad_norm")}}))
            if t.max_rss_gb > 0:
                # every process leaves together when any is over the limit
                gb = rss_gb()
                over = mesh.all_reduce_sum(torch.tensor(
                    float(gb > t.max_rss_gb), device=dev))
                if float(over) > 0:
                    if rank0:
                        r.ckpt.save(r.state, cfg)
                    print(f"RSS {gb:.1f} GB (limit {t.max_rss_gb} GB in "
                          f"{int(over)} of {mesh.world_size()} processes); "
                          f"checkpointed @ {step}, exiting "
                          f"{RSS_EXIT_CODE} for restart", flush=True)
                    raise SystemExit(RSS_EXIT_CODE)
        if r.eval_batches is not None and step % r.eval_every == 0:
            m = r.evaluate()
            say(json.dumps({"step": step,
                            "eval_epe": round(m["epe"], 4),
                            "eval_d1": round(m["d1"], 3),
                            "eval_epe_up0": round(m["epe_up0"], 4),
                            "eval_d1_up0": round(m["d1_up0"], 3)}))
        if step % t.ckpt_every == 0 and rank0:
            r.ckpt.save(r.state, cfg)
            say(f"saved checkpoint @ {step}")
    if rank0 and r.ckpt.latest_step() != r.state.step:
        r.ckpt.save(r.state, cfg)
    say(f"final checkpoint @ {r.state.step}")


def main(argv=None):
    try:
        run(prepare(argv))
        mesh.barrier()
    finally:
        mesh.leave()


if __name__ == "__main__":
    main()
