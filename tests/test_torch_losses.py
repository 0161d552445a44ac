"""The port's detail mask loss and the other loss types against
decnet_tpu/train/loss.py, in f32 on the CPU, op by op (no step compile):
focal_loss, mask_l1_loss, detail_mask_loss (with and without
binary_thold), upsample_loss, lr_consistency_loss (value and gradients
through the plain warp), chamfer_error, chamfer_loss and
multi_stage_chamfer; then the train step's loss dispatcher over the five
loss types and its refusals.

Inputs are made with numpy from a seed; maps are (B,H,W) in both
packages, features NHWC in JAX and NCHW in the port.  Tolerance 1e-5
relative: the same f32 terms summed in other orders."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from decnet_tpu.config import LossConfig as JaxLossConfig
from decnet_tpu.train import loss as jloss
from decnet_tpu_torch import config as tconfig
from decnet_tpu_torch.cli import train as tcli
from decnet_tpu_torch.train import loss as tloss
from decnet_tpu_torch.train import step as tstep
from tests.test_torch_layers import nchw
from tests.test_torch_model import CKPT
from tests.test_torch_train import loss_inputs

RTOL = 1e-5
WEIGHTS = (1.0, 0.7, 1.0, 1.3)
B, H, W, MAX_DISP = 2, 54, 81, 54


def close(got, want, msg=""):
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                               err_msg=msg)


def close_logs(tlogs, jlogs):
    assert set(tlogs) == set(jlogs)
    for k, v in jlogs.items():
        close(tlogs[k], v, k)


def detail_inputs(seed):
    """Learned detail maps in (0, 1) (a few saturated at 0 and 1) and the
    batch's binary masks, per fine stage."""
    rng = np.random.RandomState(seed)
    out = {"left_details": [], "right_details": []}
    masks = {"left_masks": [], "right_masks": []}
    for s in (9, 3, 1):
        shape = (B, H // s, W // s)
        for k in out:
            d = rng.rand(*shape).astype(np.float32)
            d.flat[:3] = (0.0, 1.0, 1.0)
            out[k].append(d)
        for k in masks:
            masks[k].append((rng.rand(*shape) < 0.3).astype(np.float32))
    return out, masks


def as_torch(tree):
    if isinstance(tree, dict):
        return {k: as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_torch(v) for v in tree]
    return torch.from_numpy(np.ascontiguousarray(tree))


def test_focal_and_mask_l1_match_jax():
    rng = np.random.RandomState(0)
    pt = rng.rand(B, 18, 27).astype(np.float32)
    pt.flat[:4] = (0.0, 1.0, 0.0, 1.0)
    gt = (rng.rand(B, 18, 27) < 0.3).astype(np.float32)
    gt.flat[:4] = (0.0, 0.0, 1.0, 1.0)
    close(tloss.focal_loss(torch.from_numpy(pt), torch.from_numpy(gt)),
          jloss.focal_loss(jnp.asarray(pt), jnp.asarray(gt)))
    close(tloss.focal_loss(torch.from_numpy(pt), torch.from_numpy(gt),
                           gamma=1.5, alpha=0.25),
          jloss.focal_loss(jnp.asarray(pt), jnp.asarray(gt), 1.5, 0.25))
    x = (rng.rand(B, 18, 27) * 3).astype(np.float32)
    close(tloss.mask_l1_loss(torch.from_numpy(x), torch.from_numpy(gt)),
          jloss.mask_l1_loss(jnp.asarray(x), jnp.asarray(gt)))
    # an empty target mask gives 0
    zeros = torch.zeros(1, 3, 3)
    assert float(tloss.mask_l1_loss(torch.ones(1, 3, 3), zeros)) == 0.0


@pytest.mark.parametrize("binary_thold", [None, 0.5])
def test_detail_mask_loss_matches_jax(binary_thold):
    out, masks = detail_inputs(1)
    jt, jl = jloss.detail_mask_loss(
        jax.tree_util.tree_map(jnp.asarray, out),
        [jnp.asarray(m) for m in masks["left_masks"]],
        [jnp.asarray(m) for m in masks["right_masks"]], WEIGHTS,
        binary_thold=binary_thold)
    tout, tmasks = as_torch(out), as_torch(masks)
    tt, tl = tloss.detail_mask_loss(tout, tmasks["left_masks"],
                                    tmasks["right_masks"], WEIGHTS,
                                    binary_thold=binary_thold)
    assert set(tl) == {f"mask{i}/{k}" for i in range(3)
                       for k in ("focal", "l1")}
    close(tt, jt)
    close_logs(tl, jl)


def test_detail_mask_loss_gradient_matches_jax():
    out, masks = detail_inputs(2)
    lm = [jnp.asarray(m) for m in masks["left_masks"]]
    rm = [jnp.asarray(m) for m in masks["right_masks"]]

    def jfn(details):
        return jloss.detail_mask_loss(details, lm, rm, WEIGHTS)[0]

    want = jax.grad(jfn)(jax.tree_util.tree_map(jnp.asarray, out))
    tout = {k: [t.requires_grad_() for t in v]
            for k, v in as_torch(out).items()}
    tmasks = as_torch(masks)
    tloss.detail_mask_loss(tout, tmasks["left_masks"], tmasks["right_masks"],
                           WEIGHTS)[0].backward()
    for k in tout:
        for i, t in enumerate(tout[k]):
            w = np.asarray(want[k][i])
            np.testing.assert_allclose(t.grad.numpy(), w, rtol=RTOL,
                                       atol=RTOL * np.abs(w).max(),
                                       err_msg=f"{k}[{i}]")


@pytest.mark.parametrize("down", ["bilinear", "bicubic"])
def test_upsample_loss_matches_jax(down):
    out, gt = loss_inputs(3)
    kw = dict(down_func_name=down, weights=WEIGHTS)
    jt, jl = jloss.upsample_loss(jax.tree_util.tree_map(jnp.asarray, out),
                                 jnp.asarray(gt), JaxLossConfig(**kw), 4, 3,
                                 MAX_DISP)
    tt, tl = tloss.upsample_loss(as_torch(out), torch.from_numpy(gt),
                                 tconfig.LossConfig(**kw), 4, 3, MAX_DISP)
    assert set(tl) == {f"stage{s}/up" for s in range(4)}
    close(tt, jt)
    close_logs(tl, jl)


def test_lr_consistency_loss_and_gradients_match_jax():
    rng = np.random.RandomState(4)
    preds, lf, rf = [], [], []
    for stage, c in enumerate((16, 16, 8, 4)):
        s = 3 ** (3 - stage)
        h, w = H // s, W // s
        preds.append((rng.rand(B, h, w) * MAX_DISP / s).astype(np.float32))
        lf.append(rng.randn(B, h, w, c).astype(np.float32))
        rf.append(rng.randn(B, h, w, c).astype(np.float32))

    def jfn(preds, lf, rf):
        return jloss.lr_consistency_loss(
            preds, {f"stage{s}": x for s, x in enumerate(lf)},
            {f"stage{s}": x for s, x in enumerate(rf)}, WEIGHTS)

    jargs = [[jnp.asarray(x) for x in xs] for xs in (preds, lf, rf)]
    want, grads = jax.value_and_grad(jfn, argnums=(0, 1, 2))(*jargs)
    targs = [[torch.from_numpy(x).requires_grad_() for x in preds],
             [nchw(x).requires_grad_() for x in lf],
             [nchw(x).requires_grad_() for x in rf]]
    got = tloss.lr_consistency_loss(*targs, WEIGHTS)
    close(got.detach(), want)
    got.backward()
    for name, ts, gs, to_np in (
            ("pred", targs[0], grads[0], lambda t: t.numpy()),
            ("left", targs[1], grads[1], lambda t: t.numpy().transpose(
                0, 2, 3, 1)),
            ("right", targs[2], grads[2], lambda t: t.numpy().transpose(
                0, 2, 3, 1))):
        for s, (t, g) in enumerate(zip(ts, gs)):
            g = np.asarray(g)
            np.testing.assert_allclose(to_np(t.grad), g, rtol=RTOL,
                                       atol=RTOL * np.abs(g).max(),
                                       err_msg=f"{name}[{s}]")


def test_chamfer_error_and_loss_match_jax():
    rng = np.random.RandomState(5)
    gt = (rng.rand(B, H, W) * 40).astype(np.float32)
    gt[rng.rand(B, H, W) < 0.3] = 0.0
    gt[:, :3, :3] = 0.0                     # a cell with no valid value
    for r in (3, 9):
        pred = (rng.rand(B, H // r, W // r) * 40).astype(np.float32)
        want = jloss.chamfer_error(jnp.asarray(pred), jnp.asarray(gt), r)
        got = tloss.chamfer_error(torch.from_numpy(pred),
                                  torch.from_numpy(gt), r)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
        mask = (rng.rand(B, H // r, W // r) < 0.5).astype(np.float32)
        for extra in (None, mask):
            close(tloss.chamfer_loss(
                torch.from_numpy(pred), torch.from_numpy(gt), r,
                None if extra is None else torch.from_numpy(extra)),
                jloss.chamfer_loss(jnp.asarray(pred), jnp.asarray(gt), r,
                                   None if extra is None
                                   else jnp.asarray(extra)))


def test_multi_stage_chamfer_matches_jax():
    out, gt = loss_inputs(6)
    gt[gt < 3] = 0.0
    kw = dict(sparse_term_scale=20.0, weights=WEIGHTS)
    jt, jl = jloss.multi_stage_chamfer(
        jax.tree_util.tree_map(jnp.asarray, out), jnp.asarray(gt),
        JaxLossConfig(**kw), 4, 3, MAX_DISP, 4)
    tt, tl = tloss.multi_stage_chamfer(as_torch(out), torch.from_numpy(gt),
                                       tconfig.LossConfig(**kw), 4, 3,
                                       MAX_DISP, 4)
    close(tt, jt)
    close_logs(tl, jl)


# -- the dispatcher -----------------------------------------------------------

def dispatch_inputs(use_detail):
    out, gt = loss_inputs(7)
    out = as_torch(out)
    details, masks = detail_inputs(8)
    if use_detail:
        out.update(as_torch(details))
    rng = np.random.RandomState(9)
    for side in ("left_feats", "right_feats"):
        out[side] = [torch.from_numpy(rng.randn(B, c, H // 3 ** (3 - s),
                                                W // 3 ** (3 - s))
                                      .astype(np.float32))
                     for s, c in enumerate((16, 16, 8, 4))]
    batch = {"gt": torch.from_numpy(gt), **as_torch(masks)}
    return out, batch


def cfg_of(loss_type, use_detail=False, s2d_fine=False, alpha=0.3):
    cfg = tconfig.Config().apply_overrides(
        [f"loss.loss_type={loss_type}", f"loss.alpha={alpha}",
         "loss.binary_thold=0.5" if "upmask" in loss_type else
         "loss.binary_thold=none"])
    cfg.model = tconfig.ModelConfig(max_disp=MAX_DISP, use_detail=use_detail,
                                    s2d_fine=s2d_fine)
    return cfg


@pytest.mark.parametrize("loss_type", tstep.LOSS_TYPES)
@pytest.mark.parametrize("use_detail", [False, True])
def test_compute_loss_dispatches_every_type(loss_type, use_detail):
    """Each type's own loss, plus alpha times the detail mask loss (and
    its terms) with learned detail heads; upmaskloss is the pure mask
    loss with binary_thold and needs the heads."""
    out, batch = dispatch_inputs(use_detail)
    cfg = cfg_of(loss_type, use_detail)
    if loss_type == tstep.UPMASK and not use_detail:
        with pytest.raises(ValueError, match="use_detail"):
            tstep.compute_loss(out, batch, cfg)
        return
    total, logs = tstep.compute_loss(out, batch, cfg)
    lc, m = cfg.loss, cfg.model
    direct = {
        "multi_stage_regression_uploss": lambda: tloss.multi_stage_uploss(
            out, batch["gt"], lc, 4, 3, MAX_DISP, 4),
        "chamfer": lambda: tloss.multi_stage_chamfer(
            out, batch["gt"], lc, 4, 3, MAX_DISP, 4),
        "multi_stage_regression_upsampleloss": lambda: tloss.upsample_loss(
            out, batch["gt"], lc, 4, 3, MAX_DISP),
        "lr_consistency": lambda: (lambda t: (t, {"lr_consistency": t}))(
            tloss.lr_consistency_loss(out["preds"], out["left_feats"],
                                      out["right_feats"], lc.weights)),
        tstep.UPMASK: lambda: tloss.detail_mask_loss(
            out, batch["left_masks"], batch["right_masks"], lc.weights,
            binary_thold=0.5),
    }[loss_type]
    want, want_logs = direct()
    if use_detail and loss_type != tstep.UPMASK:
        mloss, mlogs = tloss.detail_mask_loss(out, batch["left_masks"],
                                              batch["right_masks"],
                                              lc.weights)
        want = want + 0.3 * mloss
        want_logs = {**want_logs, **mlogs}
    assert torch.equal(total, want)
    assert set(logs) == set(want_logs)
    for k, v in want_logs.items():
        assert torch.equal(logs[k], v), k


def test_loss_type_refusals():
    with pytest.raises(ValueError, match="No such loss"):
        tstep.check_loss_type(cfg_of("nosuch"))
    with pytest.raises(ValueError, match="s2d_fine"):
        tstep.check_loss_type(cfg_of("lr_consistency", s2d_fine=True))
    assert tstep.check_loss_type(
        cfg_of("Multi_Stage_Regression_UpMaskLoss", use_detail=True)) \
        == tstep.UPMASK


@pytest.mark.parametrize("loss_type", tstep.LOSS_TYPES)
def test_train_cli_accepts_every_loss_type(loss_type, tmp_path):
    """The faithful recipe under each loss type builds a run
    (upmaskloss with the detail heads it supervises)."""
    sets = ["--set", f"loss.loss_type={loss_type}", "--set",
            "model.max_disp=27", "--set", "model.base_channels=4"]
    if loss_type == tstep.UPMASK:
        sets += ["--set", "model.use_detail=1"]
    run = tcli.prepare(["--config", os.path.join(CKPT, "config.json"),
                        "--dataset", "synthetic", "--device", "cpu",
                        "--ckpt_dir", str(tmp_path)] + sets)
    assert run.cfg.loss.loss_type == loss_type
    with pytest.raises(ValueError, match="use_detail"):
        tcli.prepare(["--dataset", "synthetic", "--device", "cpu", "--set",
                      "data.on_device=1", "--set",
                      f"loss.loss_type={tstep.UPMASK}"])
