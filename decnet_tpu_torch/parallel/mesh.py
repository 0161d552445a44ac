"""The data axis of decnet_tpu/parallel/mesh.py in torch.distributed idiom.

JAX trains one global batch over a (data, tile, disp) mesh; under jit and
GSPMD its batch statistics and every loss reduction are global by
construction.  The port runs one process per data shard instead, each on
its rows of the global batch, and makes the same quantities global by hand:
`nn/layers.py::_BatchStats` all-reduces its sums, the losses and metrics
divide their local sums by all-reduced counts (`global_sum`,
`global_mean`), and `train/step.py::loss_and_grads` sums the gradients and
the logged terms over the processes (`all_reduce_tensors`).  Each rank's
loss is then its share of the global loss, and the ranks' shares sum to it.

Without a process group, or with one process, every function here returns
its input and the step is the single-process step.  The mesh's `tile` and
`disp` axes are not ported (`config.py::MeshConfig` refuses them)."""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from decnet_tpu_torch.config import MeshConfig
from decnet_tpu_torch.device import resolve_device

AXES = ("data", "tile", "disp")
# the torchrun variables that describe a process group
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
TIMEOUT = datetime.timedelta(minutes=10)


def torchrun_env() -> bool:
    """Whether this process was started with a process group's
    variables (torchrun's, or a caller's own)."""
    return all(k in os.environ for k in TORCHRUN_ENV)


def init_distributed(device="cuda", backend: Optional[str] = None
                     ) -> torch.device:
    """Joins the process group the torchrun environment describes
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`/`MASTER_PORT`) and
    returns this process's device: `cuda:LOCAL_RANK` (ranks beyond the
    cards share them in turn, which only gloo accepts), or the CPU.  The
    backend is nccl on the card and gloo on the CPU unless one is passed."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"no process group described: {missing} unset")
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=TIMEOUT)
    return dev


def world_size() -> int:
    """The number of processes of the group, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Whether this process writes files and logs (rank 0)."""
    return rank() == 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The mesh's axis sizes; only `data` may exceed 1 in the port."""
    data: int
    tile: int = 1
    disp: int = 1

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, (self.data, self.tile, self.disp)))


def make_mesh(cfg: Optional[MeshConfig] = None,
              world: Optional[int] = None) -> Mesh:
    """The mesh over `world` processes (the group's size by default);
    `data` = -1 takes every process, as decnet_tpu's make_mesh does."""
    world = world_size() if world is None else world
    cfg = cfg or MeshConfig()
    tile, disp = max(1, cfg.tile), max(1, cfg.disp)
    data = cfg.data if cfg.data > 0 else world // (tile * disp)
    if data * tile * disp != world:
        raise ValueError(f"mesh {data}x{tile}x{disp} != {world} processes")
    return Mesh(data, tile, disp)


def shard(batch_size: int, world: Optional[int] = None,
          index: Optional[int] = None) -> Tuple[Tuple[int, int], int]:
    """((index, count), local batch): this process's shard of a global
    batch, which must divide over the processes."""
    world = world_size() if world is None else world
    index = rank() if index is None else index
    if batch_size % world:
        raise ValueError(f"global batch {batch_size} not divisible by "
                         f"{world} processes")
    return (index, world), batch_size // world


def broadcast_state(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `module` made rank `src`'s, as
    decnet_tpu's `replicated` sharding places one state on every device."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the processes, in place (t itself with one process).
    Every collective of a step goes through here."""
    if world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_reduce_tensors(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor summed over the processes, in place, through one flat
    f32 buffer."""
    if world_size() == 1 or not tensors:
        return tensors
    flat = all_reduce_sum(torch.cat([t.detach().float().flatten()
                                     for t in tensors]))
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))
    return tensors


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """A detached copy of t summed over the processes (t itself with one
    process): the global count a rank divides its local sum by."""
    if world_size() == 1:
        return t
    return all_reduce_sum(t.detach().clone())


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of x over the global batch: its sum
    over the global number of elements (x.mean() with one process)."""
    if world_size() == 1:
        return x.mean()
    n = global_sum(torch.tensor(float(x.numel()), device=x.device))
    return x.sum() / n


def barrier() -> None:
    """Wait for every process of the group."""
    if world_size() > 1:
        dist.barrier()


def leave() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()
