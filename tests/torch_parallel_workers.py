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


def cli_mesh_worker(argv):
    """The train CLI under --multihost 1 in this rank: what it printed and
    the steps it saved."""
    from decnet_tpu_torch.cli import train
    from decnet_tpu_torch.train.checkpoint import CheckpointManager
    saves, real_save = [], CheckpointManager.save

    def save(self, state, cfg):
        saves.append(state.step)
        return real_save(self, state, cfg)
    CheckpointManager.save = save
    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            train.main(argv)
    finally:
        CheckpointManager.save = real_save
    return {"log": log.getvalue(), "saves": saves}


# -- the mesh's tile and disp axes (tests/test_torch_mesh.py) ---------------

# name: (unit, its kwargs, input shape, placement); the 2D cases split H
# over tile (2 processes), the 3D ones S over disp, and H over tile too
# (4 processes, tile 2 x disp 2)
CONV_CASES = {
    "2d_stride1": ("ConvUnit", dict(in_ch=3, out_ch=4, kernel_size=3,
                                    padding=1), (2, 3, 12, 10), ("tile",)),
    "2d_stride3": ("ConvUnit", dict(in_ch=3, out_ch=4, kernel_size=3,
                                    stride=3, padding=1), (2, 3, 12, 9),
                   ("tile",)),
    "2d_dilated": ("ConvUnit", dict(in_ch=3, out_ch=4, kernel_size=3,
                                    dilation=3, padding=3), (2, 3, 12, 10),
                   ("tile",)),
    "2d_transposed": ("DeconvUnit", dict(in_ch=3, out_ch=4), (2, 3, 4, 5),
                      ("tile",)),
    "3d_s": ("Conv3dUnit", dict(in_ch=2, out_ch=3), (2, 2, 4, 6, 5),
             ("disp",)),
    "3d_s_and_h": ("Conv3dUnit", dict(in_ch=2, out_ch=3), (2, 2, 4, 6, 5),
                   ("tile", "disp")),
}
# the placements whose batch statistics reduce over their own group
BN_PLACEMENTS = {"rows": ("tile",), "whole": (), "disp": ("disp",),
                 "tile_disp": ("tile", "disp")}
MESH_SEED = 11


def part(x, split, tile_index, disp_index, tile=2, disp=2):
    """A rank's part of a global (B,C,[S,]H,W) tensor: its rows (dim -2)
    if tile is in `split`, its S slice (dim 2 of a 5-D tensor) if disp
    is."""
    if "tile" in split:
        h = x.shape[-2] // tile
        x = x.narrow(x.dim() - 2, tile_index * h, h)
    if "disp" in split:
        s = x.shape[2] // disp
        x = x.narrow(2, disp_index * s, s)
    return x.contiguous()


def conv_case(name, pos=None):
    """The unit of CONV_CASES[name] (weights from MESH_SEED), its input and
    cotangent; on a mesh, this rank's parts, the unit run under the case's
    placement and its gradients reduced as the train step reduces them.
    Returns y, dx and the weight's gradient."""
    from decnet_tpu_torch.nn import layers
    kind, kw, shape, split = CONV_CASES[name]
    torch.manual_seed(MESH_SEED)
    unit = getattr(layers, kind)(**kw, relu=False, bn=False)
    r = np.random.RandomState(MESH_SEED)
    x = torch.from_numpy(r.randn(*shape).astype(np.float32))
    with torch.no_grad():
        y = unit(x)
    g = torch.from_numpy(r.randn(*y.shape).astype(np.float32))
    if pos is not None:
        x, g = (part(t, split, pos[1], pos[2]) for t in (x, g))
    x.requires_grad_(True)
    with mesh.placed(split if pos is not None else mesh.ROWS):
        y = unit(x)
    (y * g).sum().backward()
    if pos is not None:
        mesh.reduce_gradients(unit)
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dw": unit.conv.weight.grad.numpy()}


def group_norm_case(pos=None):
    """A conv + GroupNorm unit (the `gn` norm) on (2,8,12,10) with H split
    over tile: its per-image statistics span the shards.  Returns y, dx
    and the GroupNorm scale's gradient, reduced as the train step does."""
    from decnet_tpu_torch.nn.layers import ConvUnit, norm_override
    torch.manual_seed(MESH_SEED)
    with norm_override("gn"):
        unit = ConvUnit(8, 16, 3, padding=1)
    r = np.random.RandomState(MESH_SEED + 6)
    x = torch.from_numpy(r.randn(2, 8, 12, 10).astype(np.float32))
    g = torch.from_numpy(r.randn(2, 16, 12, 10).astype(np.float32))
    if pos is not None:
        x, g = (part(t, ("tile",), pos[1], pos[2]) for t in (x, g))
    x.requires_grad_(True)
    with mesh.placed(mesh.ROWS):
        y = unit(x)
    (y * g).sum().backward()
    if pos is not None:
        mesh.reduce_gradients(unit)
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dgamma": unit.gn.weight.grad.numpy()}


def idle_axis_case(pos=None):
    """JAX's repro (tests/test_parallel.py::
    test_conv_kernel_grad_idle_mesh_axis): a 3x3 conv of (4,3,16,16) with
    H split over tile on a tile x disp mesh, loss sum(y^2).  Returns the
    kernel gradient reduced by the rule (`mesh.reduce_gradients`) and, on
    a mesh, summed over the whole world as well (the 2x bug)."""
    from decnet_tpu_torch.nn.layers import ConvUnit
    torch.manual_seed(0)
    unit = ConvUnit(3, 8, 3, padding=1, relu=False, bn=False)
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 3, 16, 16)
                         .astype(np.float32))
    if pos is not None:
        x = part(x, ("tile",), pos[1], pos[2])
    with mesh.placed(mesh.ROWS):
        y = unit(x.requires_grad_(True))
    (y ** 2).sum().backward()
    out = {}
    if pos is not None:
        world = mesh.all_reduce_sum(unit.conv.weight.grad.clone())
        out["dw_world_sum"] = world.numpy()
        mesh.reduce_gradients(unit)
    out["dw"] = unit.conv.weight.grad.numpy()
    out["dx"] = x.grad.numpy()
    return out


def bn_case(name, pos=None):
    """_BatchStats under placement BN_PLACEMENTS[name] on this rank's part
    of one (B,C,S,H,W) tensor, used as batch norm uses it: y = (x - mean)
    / sqrt(var + 1e-5) on the part; mean, variance, y and dx of
    sum(y * g), the rank's share of the loss."""
    from decnet_tpu_torch.nn.layers import _BatchStats
    split = BN_PLACEMENTS[name]
    r = np.random.RandomState(MESH_SEED + 1)
    x = torch.from_numpy((r.randn(2, 3, 4, 6, 5) * 2 + 0.5)
                         .astype(np.float32))
    g = torch.from_numpy(r.randn(*x.shape).astype(np.float32))
    if pos is not None:
        x, g = (part(t, split, pos[1], pos[2]) for t in (x, g))
    x.requires_grad_(True)
    with mesh.placed(split):
        mean, var = _BatchStats.apply(x)
    shape = (1, -1, 1, 1, 1)
    y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + 1e-5)
    (y * g).sum().backward()
    return {"mean": mean.detach().numpy(), "var": var.detach().numpy(),
            "y": y.detach().numpy(), "dx": x.grad.numpy()}


def regression_inputs():
    r = np.random.RandomState(MESH_SEED + 2)
    cost = r.randn(2, 4, 3, 5).astype(np.float32) * 3
    g = r.randn(2, 3, 5).astype(np.float32)
    return cost, g


def regression_case(pos=None):
    """The soft-argmin of (2,4,3,5) costs over S = 4 (each disp rank 2 of
    them), and its gradient of sum(pred * g)."""
    from decnet_tpu_torch.ops.regression import (disparity_regression,
                                                 uniform_disp_samples)
    cost, g = (torch.from_numpy(a) for a in regression_inputs())
    s0, n = 0, 4
    if pos is not None:
        n = 2
        s0 = pos[2] * n
        cost = cost[:, s0:s0 + n]
    cost = cost.contiguous().requires_grad_(True)
    with mesh.placed(("disp",)):
        pred = disparity_regression(cost, uniform_disp_samples(
            4, 2, 3, 5, start=s0, count=n))
    (pred * g).sum().backward()
    return {"pred": pred.detach().numpy(), "dcost": cost.grad.numpy()}


def quantile_case(pos=None):
    """The learned masks of two (2,6,9) detail maps (ties included) cut
    at their pooled quantile, and one map's own: this rank's rows."""
    from decnet_tpu_torch.config import ModelConfig
    from decnet_tpu_torch.models.decnet import (binarise_detail,
                                                binarise_detail_pair)
    cfg = ModelConfig(thold_mode="quantile", detail_density=0.25)
    r = np.random.RandomState(MESH_SEED + 3)
    lv, rv = (torch.from_numpy(np.round(r.rand(2, 6, 9), 2)
                               .astype(np.float32)) for _ in range(2))
    if pos is not None:
        lv, rv = (part(t, ("tile",), pos[1], pos[2]) for t in (lv, rv))
    with mesh.placed(mesh.ROWS):
        lm, rm = binarise_detail_pair(lv, rv, cfg)
        single = binarise_detail(lv, cfg)
    return {"left": lm.numpy(), "right": rm.numpy(),
            "single": single.numpy()}


RESIZE_CASES = {"up_bicubic": ((2, 1, 6, 8), 18, 8, "bicubic"),
                "up_bilinear": ((2, 1, 6, 8), 54, 8, "bilinear"),
                "down_bilinear": ((2, 1, 18, 8), 6, 4, "bilinear"),
                "down_bicubic": ((2, 1, 18, 8), 6, 8, "bicubic")}


def resize_case(name, pos=None):
    """`interpolate` of RESIZE_CASES[name] on this rank's rows (out_h is
    the rank's share of the image's) and its gradient of sum(y * g)."""
    from decnet_tpu_torch.ops.resize import interpolate
    shape, oh, ow, mode = RESIZE_CASES[name]
    r = np.random.RandomState(MESH_SEED + 4)
    x = torch.from_numpy(r.randn(*shape).astype(np.float32))
    g = torch.from_numpy(r.randn(shape[0], 1, oh, ow).astype(np.float32))
    if pos is not None:
        x, g = (part(t, ("tile",), pos[1], pos[2]) for t in (x, g))
        oh //= 2
    x.requires_grad_(True)
    with mesh.placed(mesh.ROWS):
        y = interpolate(x, oh, ow, mode)
    (y * g).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy()}


def warp_case(pos=None):
    """`warp_with_grad` (its plain version on the CPU) of (2,3,6,8)
    features by a (2,6,8) disparity, and the gradients of sum(y * g)."""
    from decnet_tpu_torch.ops.kernels.warp import warp_with_grad
    r = np.random.RandomState(MESH_SEED + 5)
    feat = torch.from_numpy(r.randn(2, 3, 6, 8).astype(np.float32))
    disp = torch.from_numpy((r.rand(2, 6, 8) * 5).astype(np.float32))
    g = torch.from_numpy(r.randn(2, 3, 6, 8).astype(np.float32))
    if pos is not None:
        feat, disp, g = (part(t, ("tile",), pos[1], pos[2])
                         for t in (feat, disp, g))
    feat.requires_grad_(True)
    disp.requires_grad_(True)
    with mesh.placed(mesh.ROWS):
        y = warp_with_grad(feat, disp, 6)
    (y * g).sum().backward()
    return {"y": y.detach().numpy(), "dfeat": feat.grad.numpy(),
            "ddisp": disp.grad.numpy()}


FORWARD_B = 2


def forward_case(pos=None):
    """The dry run's model (parallel/dryrun.py, fresh weights) in eval
    mode on the first FORWARD_B images of its batch: this rank's rows of
    every fine map; and on a mesh the ValueError of an image whose H does
    not divide by tile x 27."""
    from decnet_tpu_torch.models.decnet import DecNet
    from decnet_tpu_torch.parallel import dryrun
    cfg = dryrun.dryrun_config()
    model = DecNet(cfg.model)
    model.load_state_dict(dryrun.fresh_state(cfg))
    model.eval()
    b = dryrun.rows(dryrun.build_batch(), 0, dryrun.B // FORWARD_B, "cpu")
    if pos is not None:
        b = mesh.shard_batch(b)
    with torch.no_grad():
        out = model(b["left"], b["right"], b["left_masks"],
                    b["right_masks"])
    res = {k: [t.numpy() for t in out[k]]
           for k in ("preds", "masks_used", "fusion", "dense")}
    if pos is not None:
        try:
            with torch.no_grad():
                # 14 rows a rank: H = 28, not a multiple of tile x 27
                model(b["left"][:, :, :14], b["right"][:, :, :14])
        except ValueError as e:
            res["refused"] = str(e)
    return res


def mesh_module_worker(tile, disp):
    """Every case of this mesh on this rank: the 2D convolutions, the
    resizes, the warp and the forward on tile 2 x disp 1; the 3D
    convolutions, the idle-axis repro, the batch statistics, the
    soft-argmin and the quantile on tile 2 x disp 2."""
    from decnet_tpu_torch.config import MeshConfig
    mesh.init_distributed("cpu")
    m = mesh.make_mesh(MeshConfig(data=1, tile=tile, disp=disp))
    pos = m.position()
    out = {"position": pos}
    if disp == 1:
        for name, case in CONV_CASES.items():
            if case[3] == ("tile",):
                out[f"conv/{name}"] = conv_case(name, pos)
        for name in RESIZE_CASES:
            out[f"resize/{name}"] = resize_case(name, pos)
        out["group_norm"] = group_norm_case(pos)
        out["warp"] = warp_case(pos)
        mesh.reset_counts()
        out["forward"] = forward_case(pos)
        out["forward_collectives"] = {k: list(v)
                                      for k, v in mesh.COUNTS.items()}
    else:
        for name, case in CONV_CASES.items():
            if "disp" in case[3]:
                out[f"conv/{name}"] = conv_case(name, pos)
        out["idle"] = idle_axis_case(pos)
        for name in BN_PLACEMENTS:
            out[f"bn/{name}"] = bn_case(name, pos)
        out["regression"] = regression_case(pos)
        out["quantile"] = quantile_case(pos)
    return out
