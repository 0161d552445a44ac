"""The (data, tile, disp) mesh of decnet_tpu/parallel/mesh.py in
torch.distributed idiom: one process per mesh position.

JAX trains one global batch over the mesh; under jit and GSPMD its batch
statistics, loss reductions and halo exchanges are derived for it.  The
port runs one process per position and writes the exchanges by hand:

  * data: each rank takes its images of the global batch;
  * tile: each rank takes its rows of every image (H split), and the
    convolutions pad a shard's inner edge with the neighbour's rows
    (`halo`); the 1/27 level gathers conv2's rows (`gather_rows`) and is
    computed whole on every rank, then each rank takes its rows back
    (`to_rows`);
  * disp: each rank takes its slice of the stage-0 hypotheses S; the 3D
    convolutions exchange S halos and the soft-argmin merges its partial
    sums (`ops/regression.py`).

Rank r sits at data r // (tile*disp), tile (r // disp) % tile, disp
r % disp, as JAX's `make_mesh` reshapes its devices.  A tensor is split
over data and the axes of the current placement (`placed`): the model's
fine levels and the losses over tile (`ROWS`, which `DecNet.forward` and
the train step enter), the 1/27 level over none of them (`WHOLE`, also
the default outside them), the stage-0 volume over disp.  A placement's
batch statistics reduce over its group (`stats_group`), and a
parameter's gradient over the axes its computation is split on: each
unit records its placement's replica count (`replicas`, the product of
the idle axes), and `train/step.py` divides the gradient by it before
one sum over every process.  Summing over an idle axis as well would
double the gradient (decnet_tpu/ops/spmd_conv.py:1-28).  The losses and
metrics count each pixel once, over data x tile (`pixel_group`).

The collectives that a gradient crosses are autograd functions that keep
one invariant: every rank holds the true cotangent of what it holds (of its
shard, or of the whole tensor when it is replicated).  NCCL refuses two
ranks on one card, so ranks sharing a card use gloo, which takes only
broadcast and all-reduce for CUDA tensors: there `_transport` stages the
all-gathers and the point-to-point halos through host tensors.  It is the
only transport for that case, not a fallback.

Without a process group, or with one process, every function here returns
its input and the step is the single-process step."""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import math
import os
import time
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from decnet_tpu_torch.config import MeshConfig
from decnet_tpu_torch.device import resolve_device

AXES = ("data", "tile", "disp")
# the torchrun variables that describe a process group
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
TIMEOUT = datetime.timedelta(minutes=10)
DIVISIBILITY = "ROADMAP.md section 3, Known and deliberate"


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
    """The mesh's axis sizes."""
    data: int
    tile: int = 1
    disp: int = 1

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, (self.data, self.tile, self.disp)))

    @property
    def size(self) -> int:
        return self.data * self.tile * self.disp

    def position(self, r: Optional[int] = None) -> Tuple[int, int, int]:
        """(data, tile, disp) of rank r (this process's by default)."""
        r = rank() if r is None else r
        return (r // (self.tile * self.disp), (r // self.disp) % self.tile,
                r % self.disp)

    def rank_at(self, d: int, t: int, s: int) -> int:
        return (d * self.tile + t) * self.disp + s

    def stride(self, axis: str) -> int:
        """How far apart in rank two neighbours along `axis` are."""
        return {"data": self.tile * self.disp, "tile": self.disp,
                "disp": 1}[axis]

    def members(self, axes: Iterable[str], r: Optional[int] = None
                ) -> List[int]:
        """The ranks that share rank r's position on every axis but
        `axes`, in rank order."""
        pos = dict(zip(AXES, self.position(r)))
        ranges = [range(n) if a in axes else [pos[a]]
                  for a, n in zip(AXES, (self.data, self.tile, self.disp))]
        return sorted(self.rank_at(d, t, s) for d in ranges[0]
                      for t in ranges[1] for s in ranges[2])


def make_mesh(cfg: Optional[MeshConfig] = None,
              world: Optional[int] = None) -> Mesh:
    """The mesh over `world` processes (the group's size by default);
    `data` = -1 takes every process, as decnet_tpu's make_mesh does.
    Called in a process group without `world`, it also builds the mesh's
    process groups and makes it the active mesh (`active`): once per mesh,
    and every rank must call it."""
    install = world is None and dist.is_initialized()
    world = world_size() if world is None else world
    cfg = cfg or MeshConfig()
    tile, disp = max(1, cfg.tile), max(1, cfg.disp)
    data = cfg.data if cfg.data > 0 else world // (tile * disp)
    if data * tile * disp != world:
        raise ValueError(f"mesh {data}x{tile}x{disp} != {world} processes")
    m = Mesh(data, tile, disp)
    if install and (_ACTIVE is None or _ACTIVE.mesh != m):
        _install(m)
    return m


@dataclasses.dataclass
class _Active:
    mesh: Mesh
    # process groups by their axes; None is the default (whole) group, and
    # an axes set whose groups hold one rank has no entry
    groups: Dict[FrozenSet[str], object]


_ACTIVE: Optional[_Active] = None
GROUP_AXES = (("tile",), ("disp",), ("data", "tile"), ("data", "disp"),
              ("data",), ("tile", "disp"))


def _install(m: Mesh) -> None:
    """Build the groups of every axes set the slice reduces over: every
    rank creates every group, in one order, as dist.new_group requires."""
    global _ACTIVE
    groups: Dict[FrozenSet[str], object] = {}
    for axes in GROUP_AXES:
        n = math.prod(m.shape[a] for a in axes)
        if n == 1:
            continue
        if n == m.size:
            groups[frozenset(axes)] = None
            continue
        seen = set()
        for r in range(m.size):
            ranks = tuple(m.members(axes, r))
            if ranks in seen:
                continue
            seen.add(ranks)
            g = dist.new_group(list(ranks))
            if rank() in ranks:
                groups[frozenset(axes)] = g
    _ACTIVE = _Active(m, groups)


def active() -> Mesh:
    """The installed mesh, or the data-only mesh over the group."""
    if _ACTIVE is not None and _ACTIVE.mesh.size == world_size():
        return _ACTIVE.mesh
    return Mesh(world_size())


def axis_size(axis: str) -> int:
    return active().shape[axis]


def axis_index(axis: str) -> int:
    return active().position()[AXES.index(axis)]


class _Local:
    """The group of a single rank: its collectives return their input."""


LOCAL = _Local()


def group(axes: Iterable[str]):
    """The process group over `axes` that holds this rank: None for the
    whole group, LOCAL when it holds this rank alone."""
    axes = frozenset(axes)
    m = active()
    n = math.prod(m.shape[a] for a in axes)
    if n == 1:
        return LOCAL
    if n == m.size:
        return None
    return _ACTIVE.groups[axes]


# -- placements ---------------------------------------------------------------

ROWS = frozenset({"tile"})          # the fine levels: H over tile
WHOLE = frozenset()                 # the 1/27 level: whole on every rank
# whole by default: what runs outside the model and the losses (a batch's
# masks made on the device, a host resize) sees whole images
_SPLIT = contextvars.ContextVar("decnet_torch_split", default=WHOLE)


@contextlib.contextmanager
def placed(split: Iterable[str]):
    """Code inside runs on tensors split over data and the axes `split`
    (of "tile", "disp"): e.g. `placed(WHOLE)` for the 1/27 level,
    `placed({"disp"})` for the stage-0 volume."""
    tok = _SPLIT.set(frozenset(split))
    try:
        yield
    finally:
        _SPLIT.reset(tok)


def splits(axis: str) -> bool:
    """Whether the current placement splits `axis` over more than one
    rank."""
    return axis in _SPLIT.get() and axis_size(axis) > 1


def stats_group():
    """The group that a batch statistic of the current placement reduces
    over: data and the split axes."""
    return group({"data"} | _SPLIT.get())


def pixel_group():
    """The group over which each pixel of the batch is counted once: data
    x tile."""
    return group(("data", "tile"))


def replicas() -> int:
    """How many ranks repeat each computation of the current placement:
    the product of the sizes of the axes it does not split."""
    return math.prod(axis_size(a) for a in ("tile", "disp")
                     if a not in _SPLIT.get())


def rows_of(n_local: int) -> Tuple[int, int]:
    """(first global row, global rows) of this rank's `n_local` rows of a
    level under the current placement."""
    if not splits("tile"):
        return 0, n_local
    t = axis_index("tile")
    return t * n_local, n_local * axis_size("tile")


def check_divisible(height: int, levels_scale: int, hypotheses: int,
                    m: Optional[Mesh] = None) -> None:
    """Refuse a shard that JAX would pad: the image's H must divide by tile
    times the coarsest level's scale, the stage-0 S by disp (of `m`, the
    active mesh by default)."""
    m = m or active()
    if height % (m.tile * levels_scale):
        raise ValueError(f"H={height} is not divisible by tile {m.tile} x "
                         f"{levels_scale}: the port refuses uneven row "
                         f"shards ({DIVISIBILITY})")
    if hypotheses % m.disp:
        raise ValueError(f"stage-0 S={hypotheses} is not divisible by disp "
                         f"{m.disp}: the port refuses uneven hypothesis "
                         f"shards ({DIVISIBILITY})")


# -- transport ----------------------------------------------------------------

# calls and host seconds per kind of collective, since the last reset
COUNTS: Dict[str, List[float]] = {}


def reset_counts() -> None:
    COUNTS.clear()


def _count(kind: str, t0: float) -> None:
    c = COUNTS.setdefault(kind, [0, 0.0])
    c[0] += 1
    c[1] += time.perf_counter() - t0


def _staged(t: torch.Tensor) -> bool:
    """Whether t must travel through host memory: a CUDA tensor under
    gloo, which moves CUDA tensors only for broadcast and all-reduce."""
    return t.is_cuda and dist.get_backend() == "gloo"


def _all_reduce(t: torch.Tensor, grp, op=dist.ReduceOp.SUM,
                kind: str = "all_reduce") -> torch.Tensor:
    """t reduced over `grp`, in place."""
    if grp is LOCAL:
        return t
    t0 = time.perf_counter()
    dist.all_reduce(t, op=op, group=grp)
    _count(kind, t0)
    return t


def _all_gather(t: torch.Tensor, grp, dim: int) -> torch.Tensor:
    """The members' t, concatenated along `dim` in rank order."""
    if grp is LOCAL:
        return t
    t0 = time.perf_counter()
    src = t.detach().contiguous()
    host = src.cpu() if _staged(src) else src
    n = dist.get_world_size(grp)
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=grp)
    out = torch.cat(parts, dim).to(t.device)
    _count("all_gather", t0)
    return out


def _exchange(sends: List[Tuple[torch.Tensor, int]],
              recvs: List[Tuple[Tuple[int, ...], int]], like: torch.Tensor
              ) -> List[torch.Tensor]:
    """Point-to-point: each (tensor, rank) of `sends` sent, each (shape,
    rank) of `recvs` received; returns the received tensors on like's
    device, in like's dtype."""
    if not sends and not recvs:
        return []
    t0 = time.perf_counter()
    staged = _staged(like)
    ops, bufs = [], []
    for t, peer in sends:
        t = t.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if staged else t, peer))
    for shape, peer in recvs:
        b = torch.empty(shape, dtype=like.dtype,
                        device="cpu" if staged else like.device)
        bufs.append(b)
        ops.append(dist.P2POp(dist.irecv, b, peer))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    _count("halo", t0)
    return [b.to(like.device) for b in bufs]


# -- autograd-aware collectives -----------------------------------------------

class _Reduce(torch.autograd.Function):
    """Sum over a group of partial sums whose result every member then
    uses alike: backward is the identity (each member already holds the
    whole cotangent).  With `shared`, the members use the sum in split
    computations instead, whose cotangents are partial: backward sums
    them."""

    @staticmethod
    def forward(ctx, x, grp, shared):
        ctx.grp, ctx.shared = grp, shared
        return _all_reduce(x.clone(), grp)

    @staticmethod
    def backward(ctx, g):
        if ctx.shared:
            g = _all_reduce(g.contiguous().clone(), ctx.grp)
        return g, None, None


class _Enter(torch.autograd.Function):
    """A tensor replicated over a group entering computations split over
    it: the identity, whose backward sums the members' partial
    cotangents."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.grp), None


def reduce_sum(x: torch.Tensor, axes: Iterable[str],
               shared: bool = False) -> torch.Tensor:
    """x summed over the group of `axes` (`_Reduce`)."""
    grp = group(axes)
    return x if grp is LOCAL else _Reduce.apply(x, grp, shared)


def reduce_max(x: torch.Tensor, axes: Iterable[str]) -> torch.Tensor:
    """The elementwise maximum of x over the group of `axes`, without
    gradient."""
    grp = group(axes)
    if grp is LOCAL:
        return x.detach()
    return _all_reduce(x.detach().clone(), grp, dist.ReduceOp.MAX)


def enter(x: torch.Tensor, axis: str) -> torch.Tensor:
    """x, replicated over `axis`, entering computations split over it."""
    grp = group((axis,))
    return x if grp is LOCAL else _Enter.apply(x, grp)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, dim, index):
        ctx.dim, ctx.index, ctx.n = dim, index, x.shape[dim]
        return _all_gather(x, grp, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None


def gather_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole image from every tile rank's rows (dim `dim`); backward
    takes this rank's rows of the (replicated) cotangent.  Only conv2's
    rows into the 1/27 level and the quantile's detail maps go through
    here."""
    if axis_size("tile") == 1:
        return x
    return _GatherRows.apply(x, group(("tile",)), dim, axis_index("tile"))


def to_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's rows (dim `dim`) of x, which is whole on every tile
    rank; backward sums the tile ranks' cotangents into the whole one."""
    n = axis_size("tile")
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} rows do not split over tile {n} "
                         f"({DIVISIBILITY})")
    h = x.shape[dim] // n
    return enter(x, "tile").narrow(dim, axis_index("tile") * h, h)


def _edge_rows(x, dim, n, first, edge):
    """n rows beyond an image edge: zeros, or the edge row repeated."""
    if edge == "zeros":
        shape = list(x.shape)
        shape[dim] = n
        return x.new_zeros(shape)
    row = x.narrow(dim, 0 if first else x.shape[dim] - 1, 1)
    return row.expand(*[n if i == dim else -1 for i in range(x.dim())])


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, lo, hi, axis, edge):
        m = active()
        n, i = m.shape[axis], m.position()[AXES.index(axis)]
        prev = rank() - m.stride(axis) if i > 0 else None
        nxt = rank() + m.stride(axis) if i < n - 1 else None
        ctx.args = (dim, lo, hi, prev, nxt, edge)
        L = x.shape[dim]
        shape = lambda k: tuple(k if j == dim else s
                                for j, s in enumerate(x.shape))
        sends, recvs = [], []
        if prev is not None:
            if hi:
                sends.append((x.narrow(dim, 0, hi), prev))
            if lo:
                recvs.append((shape(lo), prev))
        if nxt is not None:
            if lo:
                sends.append((x.narrow(dim, L - lo, lo), nxt))
            if hi:
                recvs.append((shape(hi), nxt))
        got = iter(_exchange(sends, recvs, x))
        parts = []
        if lo:
            parts.append(next(got) if prev is not None
                         else _edge_rows(x, dim, lo, True, edge))
        parts.append(x)
        if hi:
            parts.append(next(got) if nxt is not None
                         else _edge_rows(x, dim, hi, False, edge))
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        dim, lo, hi, prev, nxt, edge = ctx.args
        L = g.shape[dim] - lo - hi
        g_top, g_bot = g.narrow(dim, 0, lo), g.narrow(dim, lo + L, hi)
        gx = g.narrow(dim, lo, L).clone()
        sends, recvs = [], []
        shape = lambda k: tuple(k if j == dim else s
                                for j, s in enumerate(gx.shape))
        if prev is not None:
            if lo:
                sends.append((g_top, prev))
            if hi:
                recvs.append((shape(hi), prev))
        if nxt is not None:
            if hi:
                sends.append((g_bot, nxt))
            if lo:
                recvs.append((shape(lo), nxt))
        got = iter(_exchange(sends, recvs, gx))
        if prev is not None and hi:
            gx.narrow(dim, 0, hi).add_(next(got))
        elif edge == "replicate" and lo:
            gx.narrow(dim, 0, 1).add_(g_top.sum(dim, keepdim=True))
        if nxt is not None and lo:
            gx.narrow(dim, L - lo, lo).add_(next(got))
        elif edge == "replicate" and hi:
            gx.narrow(dim, L - 1, 1).add_(g_bot.sum(dim, keepdim=True))
        return gx, None, None, None, None, None


def halo(x: torch.Tensor, dim: int, lo: int, hi: int, axis: str = "tile",
         edge: str = "zeros") -> torch.Tensor:
    """x with `lo` rows before and `hi` rows after along `dim`: the
    neighbours' rows (along `axis`) at a shard's inner edge, and at the
    image's own edge zeros or the edge row repeated (`edge`).  Every rank
    of the axis passes the same lo and hi, each at most its rows.
    Backward returns the halo rows' cotangents to their owners."""
    if edge not in ("zeros", "replicate"):
        raise ValueError(f"unknown edge {edge!r}")
    if lo < 0 or hi < 0 or max(lo, hi) > x.shape[dim]:
        raise ValueError(f"halo ({lo}, {hi}) of {x.shape[dim]} rows: one "
                         f"neighbour must hold it")
    if lo == 0 and hi == 0:
        return x
    if axis_size(axis) == 1:
        parts = ([_edge_rows(x, dim, lo, True, edge)] if lo else []) + [x] \
            + ([_edge_rows(x, dim, hi, False, edge)] if hi else [])
        return torch.cat(parts, dim)
    return _Halo.apply(x.contiguous(), dim, lo, hi, axis, edge)


def shard_batch(batch: Dict, m: Optional[Mesh] = None,
                images: bool = True) -> Dict:
    """This rank's part of a global batch (JAX's `batch_sharding`): its
    images (dim 0, over data; with images=False the batch holds them
    already) and rows (dim -2 of every NCHW or (B,H,W) tensor, over
    tile); whole over disp."""
    m = m or active()
    d, t, _ = m.position()

    def take(x):
        if images:
            n = x.shape[0] // m.data
            x = x[d * n:(d + 1) * n]
        if x.dim() >= 3 and m.tile > 1:
            h = x.shape[-2] // m.tile
            x = x.narrow(x.dim() - 2, t * h, h)
        return x.contiguous()
    return {k: [take(v) for v in x] if isinstance(x, list) else take(x)
            for k, x in batch.items()}


def shard(batch_size: int, world: Optional[int] = None,
          index: Optional[int] = None) -> Tuple[Tuple[int, int], int]:
    """((index, count), local batch): this process's shard of a global
    batch over the mesh's data axis, which it must divide."""
    m = active() if world is None else Mesh(world)
    count = m.data
    index = m.position()[0] if index is None else index
    if batch_size % count:
        raise ValueError(f"global batch {batch_size} not divisible by "
                         f"{count} processes")
    return (index, count), batch_size // count


def broadcast_state(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `module` made rank `src`'s, as
    decnet_tpu's `replicated` sharding places one state on every device."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src)


def all_reduce_sum(t: torch.Tensor, grp=None) -> torch.Tensor:
    """t summed over `grp` (every process by default), in place (t itself
    with one process)."""
    if world_size() > 1:
        _all_reduce(t, grp)
    return t


def all_reduce_tensors(tensors: List[torch.Tensor], grp=None
                       ) -> List[torch.Tensor]:
    """Each tensor summed over `grp` (every process by default), in place,
    through one flat f32 buffer."""
    if world_size() == 1 or not tensors or grp is LOCAL:
        return tensors
    flat = all_reduce_sum(torch.cat([t.detach().float().flatten()
                                     for t in tensors]), grp)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))
    return tensors


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """A detached copy of t summed over the pixel group (t itself with one
    process): the global count a rank divides its local sum by."""
    if world_size() == 1:
        return t
    return all_reduce_sum(t.detach().clone(), pixel_group())


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of x over the global batch: its sum
    over the global number of elements (x.mean() with one process)."""
    if world_size() == 1:
        return x.mean()
    n = global_sum(torch.tensor(float(x.numel()), device=x.device))
    return x.sum() / n


def param_replicas(model: torch.nn.Module) -> Dict[str, int]:
    """Each parameter's replica count, from the `replicas` its module (or
    the nearest module above it) recorded in the last forward: the number
    of ranks that computed its gradient alike."""
    reps: Dict[str, int] = {}
    for prefix, mod in model.named_modules():
        n = getattr(mod, "replicas", None)
        if n is None:
            continue
        for name, _ in mod.named_parameters():
            reps[f"{prefix}.{name}" if prefix else name] = n
    return reps


def reduce_gradients(model: torch.nn.Module) -> None:
    """Every parameter's gradient summed over the axes its computation was
    split on: divided by its replica count (`param_replicas`), then summed
    over every process in one flat buffer."""
    if world_size() == 1:
        return
    reps = param_replicas(model)
    grads = []
    for name, p in model.named_parameters():
        n = reps.get(name, 1)
        if n > 1:
            p.grad.div_(n)
        grads.append(p.grad)
    all_reduce_tensors(grads)


def barrier() -> None:
    """Wait for every process of the group."""
    if world_size() > 1:
        dist.barrier()


def leave() -> None:
    """Leave the process group, if this process is in one."""
    global _ACTIVE
    _ACTIVE = None
    if dist.is_initialized():
        dist.destroy_process_group()
