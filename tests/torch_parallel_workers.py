"""What the processes of tests/test_torch_parallel.py run.  A spawned
process imports its function by module path, so these live apart from the
test module, which imports JAX.

`unit_results(rank, world)` computes the batch-norm units and the losses on
rank's rows of fixed inputs (the whole batch with world 1): the test runs
it alone in its own process and in each of two gloo processes, and sums or
concatenates the ranks' results."""
from __future__ import annotations

import contextlib
import io
import os

import numpy as np
import torch

from decnet_tpu_torch.config import LossConfig
from decnet_tpu_torch.nn.layers import FoldedBatchNorm, _BatchStats
from decnet_tpu_torch.parallel import mesh
from decnet_tpu_torch.train import loss as tloss
from decnet_tpu_torch.train.metrics import epe_and_d1

B = 4
BN_SHAPES = {"2d": (B, 6, 9, 11), "3d": (B, 5, 3, 7, 8)}
# per-rank shares of valid ground truth (rank 0's rows, rank 1's rows):
# unequal, so that a mean of the ranks' means would be wrong
VALID = (0.3, 0.8)
NUM_STAGE, DOWN, MAX_DISP, H, W = 4, 3, 54, 54, 81


def _rows(x, rank, world):
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def _bn_inputs(shape, seed):
    r = np.random.RandomState(seed)
    x = (r.randn(*shape) * 2 + 0.5).astype(np.float32)
    g = r.randn(*shape).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(g)


def bn_results(kind, rank, world):
    """A train-mode FoldedBatchNorm (random scale and bias) on rank's
    rows: its output, the batch mean and variance, the running statistics
    after it, and the gradients of sum(y * g) (dx of the rows, dscale and
    dbias this rank's share)."""
    x, g = _bn_inputs(BN_SHAPES[kind], 7)
    C = x.shape[1]
    bn = FoldedBatchNorm(C).train()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, C))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, C))
        bn.running_mean.fill_(0.1)
        bn.running_var.fill_(0.9)
    x = _rows(x, rank, world).clone().requires_grad_(True)
    y = bn(x)
    (y * _rows(g, rank, world)).sum().backward()
    with torch.no_grad():
        mean, var = _BatchStats.apply(x.detach())
    return {"y": y.detach().numpy(), "mean": mean.numpy(),
            "var": var.numpy(), "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy(),
            "dx": x.grad.numpy(), "dscale": bn.weight.grad.numpy(),
            "dbias": bn.bias.grad.numpy()}


def _loss_inputs(seed):
    """Fixed outputs of a 4-stage model at 54x81 and a ground truth whose
    valid share differs between the two halves of the batch."""
    r = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    gt = r.rand(B, H, W) * 40 + 1
    for half, share in enumerate(VALID):
        rows = slice(half * B // 2, (half + 1) * B // 2)
        gt[rows][r.rand(B // 2, H, W) > share] = 0.0
    out = {"preds": [], "dense": [], "sparse": [], "fusion": [],
           "masks_used": [], "cand": []}
    for stage in range(NUM_STAGE):
        d = DOWN ** (NUM_STAGE - stage - 1)
        shape = (B, -(-H // d), -(-W // d))
        out["preds"].append(t(r.rand(*shape) * 40 / d))
        if stage:
            for k in ("dense", "sparse", "fusion"):
                out[k].append(t(r.rand(*shape) * 40 / d))
            out["masks_used"].append(t(r.rand(*shape) < 0.3))
            out["cand"].append(t(r.rand(*shape) < 0.7))
    feats = [t(r.randn(B, 4, -(-H // DOWN ** (NUM_STAGE - s - 1)),
                       -(-W // DOWN ** (NUM_STAGE - s - 1))))
             for s in range(NUM_STAGE)]
    probs = t(r.rand(B, H, W))
    target = t(r.rand(B, H, W) < 0.3)
    # a mask with nothing in the first half of the batch (rank 0's rows)
    second = torch.arange(B)[:, None, None] >= B // 2
    return t(gt), out, feats, probs, target, second


def loss_results(rank, world):
    """Each loss on rank's rows (its share of the global loss under a
    group), and epe/d1 (global under a group)."""
    gt, out, feats, probs, target, second = _loss_inputs(11)
    rows = lambda x: _rows(x, rank, world)
    out = {k: [rows(x) for x in v] for k, v in out.items()}
    gt, probs, target, second = (rows(gt), rows(probs), rows(target),
                                 rows(second))
    feats = [rows(f) for f in feats]
    lcfg = LossConfig(sparse_cand_mask=True)
    res = {}
    res["masked_mean"] = tloss.masked_mean(gt * 2, gt > 0)
    # empty on rank 0 only, and empty everywhere
    res["masked_mean_rank0_empty"] = tloss.masked_mean(gt,
                                                       (gt > 0) & second)
    res["masked_mean_empty"] = tloss.masked_mean(gt, gt < 0)
    res["focal"] = tloss.focal_loss(probs, target)
    res["mask_l1"] = tloss.mask_l1_loss(probs, target.float())
    res["uploss"] = tloss.multi_stage_uploss(out, gt, lcfg, NUM_STAGE, DOWN,
                                             MAX_DISP)[0]
    res["upsample"] = tloss.upsample_loss(out, gt, lcfg, NUM_STAGE, DOWN,
                                          MAX_DISP)[0]
    res["chamfer"] = tloss.multi_stage_chamfer(out, gt, lcfg, NUM_STAGE,
                                               DOWN, MAX_DISP)[0]
    res["lr_consistency"] = tloss.lr_consistency_loss(
        out["preds"], feats, [torch.roll(f, 1, 3) for f in feats],
        (1.0, 0.5, 0.25, 0.125))
    epe, d1 = epe_and_d1(out["preds"][-1], gt, MAX_DISP)
    res["epe"], res["d1"] = epe, d1
    return {k: float(v) for k, v in res.items()}


def unit_results(rank=0, world=1):
    return {"bn": {k: bn_results(k, rank, world) for k in BN_SHAPES},
            "loss": loss_results(rank, world)}


def units_worker():
    mesh.init_distributed("cpu")
    return unit_results(mesh.rank(), mesh.world_size())


def cli_worker(argv, refused_argv, refused_port):
    """The train CLI under --multihost 1 in this rank: returns what it
    printed, the steps it saved, and the batches of sample indices of its
    loader's first epoch; then `prepare` with `refused_argv` in a new
    group on `refused_port`, and the error it raised."""
    from decnet_tpu_torch.cli import train
    from decnet_tpu_torch.data.loader import DataLoader
    from decnet_tpu_torch.train.checkpoint import CheckpointManager
    epochs, saves = [], []
    real_epoch, real_save = DataLoader._epoch, CheckpointManager.save

    def epoch(self):
        batches = real_epoch(self)
        epochs.append([[int(i) for i in b] for b in batches])
        return batches

    def save(self, state, cfg):
        saves.append(state.step)
        return real_save(self, state, cfg)
    DataLoader._epoch, CheckpointManager.save = epoch, save
    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            train.main(argv)
    finally:
        DataLoader._epoch, CheckpointManager.save = real_epoch, real_save
    os.environ["MASTER_PORT"] = str(refused_port)
    refused = None
    try:
        train.prepare(refused_argv)
    except ValueError as e:
        refused = str(e)
    finally:
        mesh.leave()
    return {"log": log.getvalue(), "saves": saves, "epoch": epochs[0],
            "refused": refused}
