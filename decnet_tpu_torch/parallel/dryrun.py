"""One train step split over a (data, tile, disp) mesh of processes, held
to a single-process replay — the twin of __graft_entry__.py::
dryrun_multichip and scripts/two_process_train.py.

`dryrun_multichip(n, device)` picks the mesh as JAX's dry run does (tile 2
when n is even, then disp 2 when 2 * tile divides n, data the rest: 2 ->
1x2x1, 4 -> 1x2x2, 8 -> 2x2x2), starts n processes (the `spawn` start
method), joins them into one process group, and gives each only its part
(images over data, rows over tile) of the fixed batch of
scripts/two_process_train.py (B=4 of 54x54, seed 123; the stage-0 volume
has S = 2 hypotheses, one a disp rank).  Each takes one full train step
of the dry run's configuration
(__graft_entry__.py's flagship model at max_disp 54, base_channels 4, f32,
learned quantile detail heads, the learned temperature 3.0, window 12,
cand_fallback): the loss and its gradients with global batch statistics,
the gradients summed over the processes, the clip and Adam.  This process
then replays the same step alone on the whole batch, and the two must
agree as JAX's dry run requires: loss 2e-5 and grad norm 2e-4 relative
(in f32 without TF32 on the card).

`data_parallel_step` is the machinery, for any config (its `mesh`),
weights and batch: `chip_smoke.py` drives it with the faithful recipe on
the card.  Every process has a deadline: a rendezvous that hangs fails
instead of waiting.

Usage:
  python -m decnet_tpu_torch.parallel.dryrun [N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import queue
import socket
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from decnet_tpu_torch.config import Config, MeshConfig, ModelConfig
from decnet_tpu_torch.device import resolve_device
from decnet_tpu_torch.models.decnet import DecNet
from decnet_tpu_torch.parallel import mesh
from decnet_tpu_torch.train.step import create_train_state, train_step

B, H, W, SEED = 4, 54, 54, 123
LOSS_RTOL, GRAD_NORM_RTOL = 2e-5, 2e-4
# every parameter's gradient norm against the replay's: a gradient summed
# over an idle mesh axis comes back 2x.  A leaf whose norm is below
# LEAF_FLOOR of the whole gradient's is zero up to rounding (a batch-norm
# bias ahead of a mean-free path), and its ratio is noise.
LEAF_BAND, LEAF_FLOOR = (0.9, 1.1), 1e-7
DEADLINE_S = 600.0
# __graft_entry__.py::_flagship_config as its dry run changes it (:80-95)
DRYRUN_MODEL = dict(max_disp=54, base_channels=4, num_stage=4, down_scale=3,
                    cost_func="cor", use_detail=True, thold=0.9,
                    dtype="float32", s2d_fine=True, s2d_stages=2,
                    match_window=12, cand_fallback=True,
                    thold_mode="quantile", detail_density=0.25,
                    match_temp=3.0, match_temp_learned=True)
# fresh weights: an untrained detail head saturates its sigmoid, where the
# strict quantile cut keeps no pixel, so its last kernel is scaled to give
# the masks their density; each Refinement's last conv is scaled so that
# its residuals stay within the warp's clip range (as the CPU tests do)
HEAD_SCALE, REFINE_SCALE = 0.05, 0.01


def mesh_for(n: int) -> MeshConfig:
    """The mesh of JAX's dry run on n devices (__graft_entry__.py:96-99)."""
    tile = 2 if n % 2 == 0 and n >= 2 else 1
    disp = 2 if n % (tile * 2) == 0 and n >= tile * 2 else 1
    return MeshConfig(data=n // (tile * disp), tile=tile, disp=disp)


def dryrun_config(n: int = 1) -> Config:
    cfg = Config()
    cfg.model = ModelConfig(**DRYRUN_MODEL)
    cfg.train.batch_size = B
    cfg.mesh = mesh_for(n)
    return cfg


def build_batch() -> Dict:
    """scripts/two_process_train.py::build_batch, NCHW: left/right
    (B,3,H,W), gt (B,H,W), masks per fine stage, coarsest first."""
    r = np.random.RandomState(SEED)
    mk = lambda h, w: (r.rand(B, h, w) < 0.4).astype(np.float32)
    left = r.rand(B, H, W, 3).astype(np.float32)
    right = r.rand(B, H, W, 3).astype(np.float32)
    gt = (r.rand(B, H, W) * 20).astype(np.float32)
    lm = [mk(H // 9, W // 9), mk(H // 3, W // 3), mk(H, W)]
    rm = [mk(H // 9, W // 9), mk(H // 3, W // 3), mk(H, W)]
    t = torch.from_numpy
    return {"left": t(left).permute(0, 3, 1, 2).contiguous(),
            "right": t(right).permute(0, 3, 1, 2).contiguous(),
            "gt": t(gt), "left_masks": [t(m) for m in lm],
            "right_masks": [t(m) for m in rm]}


def fresh_state(cfg: Config, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The model's initialisation drawn from `seed`, with the detail heads'
    and Refinements' last kernels scaled (HEAD_SCALE, REFINE_SCALE)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = DecNet(cfg.model)
    with torch.no_grad():
        for name, m in model.named_children():
            if name.startswith("detail_"):
                m.head1.conv.weight.mul_(HEAD_SCALE)
            if name.startswith("refine_"):
                for p in m.c6.conv.parameters():
                    p.mul_(REFINE_SCALE)
    return model.state_dict()


def rows(batch: Dict, index: int, count: int, device) -> Dict:
    """Shard `index` of `count` of a batch's rows, on `device`."""
    n = batch["gt"].shape[0] // count
    take = lambda t: t[index * n:(index + 1) * n].to(device)
    return {k: [take(m) for m in v] if isinstance(v, list) else take(v)
            for k, v in batch.items()}


def kernel_counters() -> Dict:
    """The kernel wrappers, whose `launches` attributes count their
    launches in this process."""
    from decnet_tpu_torch.ops.kernels import spamat, warp
    return {"spamat_moments": spamat.moments, "warp": warp.warp,
            "spamat_dref": spamat.spamat_dref,
            "spamat_dtar": spamat.spamat_dtar}


def take_steps(cfg: Config, state: Dict[str, torch.Tensor], batch: Dict,
               device, steps: int = 1, full: bool = True) -> Dict:
    """`steps` train steps from `state` on `batch` (on `device`, this
    rank's part), under whatever process group and mesh this process is
    in.  Returns the first step's loss, grad norm and (with `full`) its
    clipped gradient (flat, f32) and the state after it; every step's wall
    ms; the kernel launches of all the steps; the peak device memory; the
    collectives by kind, [calls, host seconds], of the first step
    (`collectives_first`) and of the later ones (`collectives`; on the card
    their seconds include the wait for the work queued before each call),
    and the host seconds and calls of the later steps' all-reduces."""
    dev = torch.device(device)
    model = DecNet(cfg.model)
    model.load_state_dict(state)
    st = create_train_state(model.to(dev), cfg)
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mesh.reset_counts()
    out = {"step_ms": []}
    for i in range(steps):
        sync()
        t = time.perf_counter()
        logs = train_step(st, batch, cfg)
        sync()
        out["step_ms"].append((time.perf_counter() - t) * 1e3)
        if i == 0:
            out["loss"] = float(logs["total"])
            out["grad_norm"] = float(logs["grad_norm"])
            if full:
                out["grads"] = torch.cat([p.grad.float().flatten()
                                          for p in model.parameters()]
                                         ).cpu().numpy()
                out["leaf_norms"] = {k: float(p.grad.double().norm())
                                     for k, p in model.named_parameters()}
                out["state"] = {k: v.float().cpu().numpy()
                                for k, v in model.state_dict().items()}
            out["collectives_first"] = {k: list(v) for k, v in
                                        mesh.COUNTS.items()}
            mesh.reset_counts()
    out["collectives"] = {k: list(v) for k, v in mesh.COUNTS.items()}
    out["launches"] = {k: c.launches for k, c in counters.items()}
    out["all_reduce_calls"], out["all_reduce_s"] = out["collectives"].get(
        "all_reduce", [0, 0.0])
    out["peak_mem_mb"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 20
                          if dev.type == "cuda" else None)
    if mesh.world_size() > 1:
        # every rank must hold rank 0's parameters and statistics
        flat = torch.cat([v.float().flatten()
                          for v in model.state_dict().values()])
        ref = flat.clone()
        dist.broadcast(ref, 0)
        out["rank_max_abs_diff"] = float((flat - ref).abs().max())
    return out


def leaf_outliers(got: Dict[str, float], want: Dict[str, float]
                  ) -> Dict[str, float]:
    """{leaf: norm ratio} of the leaves whose gradient norm in `got` is
    outside LEAF_BAND of the norm in `want` (leaves above LEAF_FLOOR)."""
    total = sum(v * v for v in want.values()) ** 0.5
    bad = {}
    for k, w in want.items():
        if w <= LEAF_FLOOR * total and got[k] <= LEAF_FLOOR * total:
            continue
        ratio = got[k] / w if w > 0 else float("inf")
        if not LEAF_BAND[0] <= ratio <= LEAF_BAND[1]:
            bad[k] = ratio
    return bad


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, fn: Callable, args: tuple,
           threads: int, out: "mp.Queue") -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    if threads:
        torch.set_num_threads(threads)
    try:
        out.put((rank, fn(*args), None))
    except BaseException:
        out.put((rank, None, traceback.format_exc()))
        raise
    finally:
        mesh.leave()


def spawn(n: int, fn: Callable, args: tuple = (), threads: int = 0,
          deadline_s: float = DEADLINE_S) -> List:
    """fn(*args) in n new processes (`spawn`), each with the variables of
    one rank of an n-process group on a free local port and at most
    `threads` CPU threads (0: torch's default); fn joins the group itself
    (`mesh.init_distributed`).  Returns the ranks' results
    in order; raises with the failing rank's traceback, or when the
    deadline passes (the processes are then killed)."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry,
                         args=(r, n, port, fn, args, threads, q),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    results: Dict[int, object] = {}
    try:
        while len(results) < n:
            try:
                left = max(1.0, end - time.monotonic())
                rank, res, err = q.get(timeout=left)
            except queue.Empty:
                raise TimeoutError(f"{n} processes: no result from ranks "
                                   f"{sorted(set(range(n)) - set(results))} "
                                   f"within {deadline_s:.0f} s") from None
            if err is not None:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{err}")
            results[rank] = res
            if time.monotonic() > end:
                raise TimeoutError(f"{n} processes outlived {deadline_s} s")
        for p in procs:
            p.join(timeout=max(1.0, end - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(n)]


def tf32() -> Tuple[bool, bool]:
    """Whether cuDNN's convolutions and cuBLAS's matmuls may use TF32."""
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def set_tf32(flags: Tuple[bool, bool]) -> None:
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = flags


def _dp_worker(cfg: Config, state: Dict, batch: Dict, device: str,
               backend: Optional[str], steps: int,
               tf32_flags: Tuple[bool, bool]) -> Dict:
    set_tf32(tf32_flags)
    dev = mesh.init_distributed(device, backend)
    m = mesh.make_mesh(cfg.mesh)
    part = mesh.shard_batch(rows(batch, 0, 1, dev), m)
    out = take_steps(cfg, state, part, dev, steps, full=mesh.is_main())
    out["device"] = str(dev)
    out["backend"] = dist.get_backend()
    out["position"] = m.position()
    return out


def data_parallel_step(n: int, cfg: Config, state: Dict, batch: Dict,
                       device="cuda", backend: Optional[str] = None,
                       steps: int = 1, threads: int = 0,
                       deadline_s: float = DEADLINE_S) -> List[Dict]:
    """`take_steps` in n processes of one group on the mesh cfg.mesh, each
    on its part of `batch` (CPU tensors, the global batch: its images over
    data, its rows over tile, `mesh.shard_batch`), from the same `state`.
    Ranks share the cards in turn, so n beyond the card count needs gloo
    (the default then; nccl otherwise on the card, gloo on the CPU).
    `threads` caps each process's CPU threads; the processes use TF32 as
    this one does.  Rank 0's result carries the gradient and the state
    after the first step."""
    dev = resolve_device(device)
    if backend is None and dev.type == "cuda":
        backend = "nccl" if n <= torch.cuda.device_count() else "gloo"
    return spawn(n, _dp_worker, (cfg, state, batch, dev.type, backend,
                                 steps, tf32()), threads, deadline_s)


def dryrun_multichip(n: int = 2, device="cuda", threads: int = 0,
                     mesh_cfg: Optional[MeshConfig] = None) -> Dict:
    """One step of the dry run's config on n processes against this
    process's replay on the whole batch (module docstring), in f32
    without TF32 on the card (TF32 rounds each split of the batch its own
    way, ~1e-3); prints JAX's line and returns both results.  Raises when
    they disagree.  `mesh_cfg` replaces JAX's choice of mesh."""
    dev = resolve_device(device)
    cfg = dryrun_config(n)
    if mesh_cfg is not None:
        cfg.mesh = mesh_cfg
    if B % cfg.mesh.data:
        raise ValueError(f"the dry run's batch of {B} does not split over "
                         f"{cfg.mesh.data} data ranks")
    state, batch = fresh_state(cfg), build_batch()
    flags = tf32()
    set_tf32((False, False))
    try:
        ranks = data_parallel_step(n, cfg, state, batch, dev.type,
                                   threads=threads)
        replay = take_steps(dryrun_config(), state, rows(batch, 0, 1, dev),
                            dev)
    finally:
        set_tf32(flags)
    total, gnorm = ranks[0]["loss"], ranks[0]["grad_norm"]
    for r, res in enumerate(ranks):
        if res["rank_max_abs_diff"] != 0:
            raise AssertionError(f"rank {r}'s state differs from rank 0's by "
                                 f"{res['rank_max_abs_diff']}")
    np.testing.assert_allclose(total, replay["loss"], rtol=LOSS_RTOL,
                               err_msg=f"{n}-process loss {total} != "
                               f"single-process {replay['loss']}")
    np.testing.assert_allclose(gnorm, replay["grad_norm"],
                               rtol=GRAD_NORM_RTOL,
                               err_msg=f"{n}-process grad_norm {gnorm} != "
                               f"single-process {replay['grad_norm']}")
    bad = leaf_outliers(ranks[0]["leaf_norms"], replay["leaf_norms"])
    if bad:
        raise AssertionError(f"{n}-process gradient norms outside "
                             f"{LEAF_BAND} of the replay's: {bad}")
    print(f"dryrun_multichip({n}): mesh="
          f"{mesh.make_mesh(cfg.mesh, world=n).shape} loss={total:.4f} "
          f"(single-process replay {replay['loss']:.4f}) "
          f"grad_norm={gnorm:.4f} (replay {replay['grad_norm']:.4f}) OK",
          flush=True)
    return {"ranks": ranks, "replay": replay}


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("n", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    dryrun_multichip(a.n, a.device)


if __name__ == "__main__":
    main()
