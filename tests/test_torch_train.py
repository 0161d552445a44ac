"""Pieces of the port's training path against the JAX package, in f32 on
the CPU: the train-mode batch norm, the ground-truth pyramid, the loss,
the metrics, the schedules and the optimizer; the grad_method repair; the
config loader; the reverse weight bridge; the train CLI.

Inputs are made with numpy from a seed.  Tolerances: exact where both
sides do the same arithmetic (the weight bridge bit for bit, the freeze
step's statistics); 1e-6 for the schedules (the port's f64 against optax's
f32) and the optimizer; 1e-5 relative for reductions summed in other
orders (batch statistics, masked means); bf16 batch norm to one bf16
rounding (2^-7)."""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from decnet_tpu.config import Config as JaxConfig
from decnet_tpu.config import LossConfig as JaxLossConfig
from decnet_tpu.config import ModelConfig as JaxModelConfig
from decnet_tpu.config import TrainConfig as JaxTrainConfig
from decnet_tpu.nn import layers as jlayers
from decnet_tpu.ops import resize as jresize
from decnet_tpu.train import checkpoint as jckpt
from decnet_tpu.train import loss as jloss
from decnet_tpu.train import metrics as jmetrics
from decnet_tpu.train import state as jstate
from decnet_tpu_torch import config as tconfig
from decnet_tpu_torch.cli import train as tcli
from decnet_tpu_torch.models import DecNet
from decnet_tpu_torch.nn import layers as tlayers
from decnet_tpu_torch.ops import resize as tresize
from decnet_tpu_torch.train import checkpoint as tckpt
from decnet_tpu_torch.train import loss as tloss
from decnet_tpu_torch.train import metrics as tmetrics
from decnet_tpu_torch.train import state as tstate
from decnet_tpu_torch.train import step as tstep
from decnet_tpu_torch.weights import flax_arrays_from_model, load_flax_variables
from tests.test_torch_layers import nchw, nhwc
from tests.test_torch_model import CKPT, FAITHFUL_SMALL, template

RTOL = 1e-5


def f32_model(ckpt_dir):
    """The checkpoint's DecNet with its weights stored in f32, as training
    holds them (the serving loader stores them in the compute dtype)."""
    cfg = tconfig.load_full_config(ckpt_dir)
    model = tstep.create_train_state(DecNet(cfg.model), cfg).model
    load_flax_variables(model, os.path.join(ckpt_dir, "params.npz"))
    return model


# -- batch norm ------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [((2, 5, 7, 6), "float32"),
                                         ((2, 3, 4, 5, 6), "float32"),
                                         ((2, 5, 7, 6), "bfloat16")])
def test_batch_norm_train_mode_matches_flax(shape, dtype):
    rng = np.random.RandomState(0)
    C = shape[-1]
    x = (rng.randn(*shape) * 2.0 + 0.7).astype(np.float32)
    params = {"scale": (1 + 0.2 * rng.randn(C)).astype(np.float32),
              "bias": (0.1 * rng.randn(C)).astype(np.float32)}
    stats = {"mean": (0.2 * rng.randn(C)).astype(np.float32),
             "var": (0.5 + rng.rand(C)).astype(np.float32)}
    jx = jnp.asarray(x, dtype)
    want, mut = jlayers.FoldedBatchNorm().apply(
        {"params": params, "batch_stats": stats}, jx,
        use_running_average=False, mutable=["batch_stats"])
    bn = tlayers.FoldedBatchNorm(C)
    bn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(stats["mean"]),
                        "running_var": torch.from_numpy(stats["var"])})
    tx = nchw(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = bn.train()(tx)
    assert got.dtype == tx.dtype
    # bf16: both cast the folded f32 affine to bf16 and apply it in bf16
    tol = RTOL if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(nhwc(got.float()),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    for k, tk in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(bn, tk).numpy(),
                                   np.asarray(mut["batch_stats"][k]),
                                   rtol=RTOL, atol=1e-7, err_msg=k)
    # eval mode normalises with the (now updated) running statistics
    run = {k: np.asarray(v) for k, v in mut["batch_stats"].items()}
    want_eval = jlayers.FoldedBatchNorm().apply(
        {"params": params, "batch_stats": run}, jx, use_running_average=True)
    np.testing.assert_allclose(nhwc(bn.eval()(tx).float()),
                               np.asarray(want_eval.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("make,shape", [
    (lambda: tlayers.ConvUnit(4, 6, 3, padding=1, dtype=torch.bfloat16),
     (2, 4, 9, 9)),
    (lambda: tlayers.DeconvUnit(4, 6, dtype=torch.bfloat16), (2, 4, 5, 7)),
    (lambda: tlayers.Conv3dUnit(4, 6, dtype=torch.bfloat16),
     (2, 4, 3, 5, 7))])
def test_units_keep_compute_dtype_with_f32_weights(make, shape):
    """For training the weights are stored in f32 and cast per call: the
    output equals the unit with weights stored in the compute dtype."""
    torch.manual_seed(0)
    unit = make()
    x = torch.randn(*shape)
    want = unit.eval()(x)
    got = unit.float().eval()(x)
    assert unit.conv.weight.dtype == torch.float32
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


# -- ground truth, loss, metrics ---------------------------------------------

@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "max", "min"])
def test_downsample_gt_matches_jax(mode):
    rng = np.random.RandomState(1)
    gt = (rng.rand(2, 27, 54) * 60).astype(np.float32)
    gt[:, :3, :5] = 0.0                       # invalid pixels
    for down in (3, 9):
        want = jresize.downsample_gt(jnp.asarray(gt), down, mode)
        got = tresize.downsample_gt(torch.from_numpy(gt), down, mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=1e-5)


def loss_inputs(seed, B=2, H=54, W=81, max_disp=54):
    rng = np.random.RandomState(seed)
    gt = (rng.rand(B, H, W) * 70 - 5).astype(np.float32)
    out = {k: [] for k in ("preds", "dense", "sparse", "fusion",
                           "masks_used", "cand")}
    for stage in range(4):
        s = 3 ** (3 - stage)
        h, w = H // s, W // s
        d = max_disp / s
        out["preds"].append((rng.rand(B, h, w) * d).astype(np.float32))
        if stage:
            for k in ("dense", "sparse", "fusion"):
                out[k].append((rng.rand(B, h, w) * d).astype(np.float32))
            for k in ("masks_used", "cand"):
                out[k].append((rng.rand(B, h, w) < 0.4).astype(np.float32))
    return out, gt


@pytest.mark.parametrize("down,overmask,cand_mask,scale", [
    ("bicubic", False, True, 20.0), ("bilinear", True, False, 1.0),
    ("min", False, True, 1.0)])
def test_multi_stage_uploss_matches_jax(down, overmask, cand_mask, scale):
    out, gt = loss_inputs(2)
    kw = dict(down_func_name=down, if_overmask=overmask,
              sparse_cand_mask=cand_mask, sparse_term_scale=scale,
              weights=(1.0, 0.7, 1.0, 1.3))
    jtotal, jlogs = jloss.multi_stage_uploss(
        jax.tree_util.tree_map(jnp.asarray, out), jnp.asarray(gt),
        JaxLossConfig(**kw), 4, 3, 54, 4)
    tout = {k: [torch.from_numpy(a) for a in v] for k, v in out.items()}
    ttotal, tlogs = tloss.multi_stage_uploss(
        tout, torch.from_numpy(gt), tconfig.LossConfig(**kw), 4, 3, 54, 4)
    assert set(tlogs) == set(jlogs)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=RTOL)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(tlogs[k]), float(v), rtol=RTOL,
                                   err_msg=k)


def test_masked_mean_of_an_empty_mask_is_zero():
    x = torch.ones(2, 3)
    assert float(tloss.masked_mean(x, torch.zeros(2, 3))) == 0.0


def test_epe_and_d1_match_jax():
    rng = np.random.RandomState(3)
    gt = (rng.rand(2, 30, 40) * 80 - 5).astype(np.float32)
    pred = gt + (rng.randn(2, 30, 40) * 4).astype(np.float32)
    want = jmetrics.epe_and_d1(jnp.asarray(pred), jnp.asarray(gt), 64)
    got = tmetrics.epe_and_d1(torch.from_numpy(pred), torch.from_numpy(gt),
                              64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=RTOL)


# -- schedules and optimizer --------------------------------------------------

@pytest.mark.parametrize("schedule,warmup,total", [
    ("cosine", 500, 18000), ("cosine", 3, 40), ("cosine", 500, 6),
    ("constant", 0, 10), ("piecewise", 0, 40)])
def test_schedules_match_optax(schedule, warmup, total):
    kw = dict(lr=1e-3, lr_schedule=schedule, warmup_steps=warmup,
              total_steps=total)
    want = jstate.make_schedule(JaxTrainConfig(**kw))
    got = tstate.make_schedule(tconfig.TrainConfig(**kw))
    counts = sorted(set(range(0, min(total, 60) + 5))
                    | {total // 2, total - 1, total, total + 7})
    # optax evaluates in f32 as differences of lr-sized terms, so its
    # value carries ~1e-7 * lr of rounding (the port's is f64): 1e-6 * lr
    for c in counts:
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6,
                                   atol=1e-6 * kw["lr"], err_msg=f"count {c}")
    if schedule == "cosine":
        assert got(0) == 0.0            # the first update has rate 0


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_clip_and_adam_match_optax(weight_decay):
    """torch.optim.Adam/AdamW at the scheduled rate, after optax's clip,
    give optax's updates: 4 steps, gradient norms above and below 10."""
    rng = np.random.RandomState(4)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    cfg = dict(lr=1e-2, lr_schedule="cosine", warmup_steps=2,
               total_steps=20, weight_decay=weight_decay)
    tx = jstate.make_optimizer(JaxTrainConfig(**cfg))
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    tcfg = tconfig.TrainConfig(**cfg)
    opt = tstate.make_optimizer(tp, tcfg)
    sched = tstate.make_schedule(tcfg)
    for count, gscale in enumerate((30.0, 0.5, 20.0, 1.0)):
        grads = [(rng.randn(*s) * gscale).astype(np.float32) for s in shapes]
        upd, opt_state = tx.update([jnp.asarray(g) for g in grads],
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        tg = [p.grad for p in tp]
        norm = tstate.global_norm(tg)
        np.testing.assert_allclose(
            float(norm), np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                     for g in grads)), rtol=1e-6)
        tstate.clip_by_global_norm(tg, norm)
        tstate.apply_updates(opt, sched, count)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)


def test_clip_is_optax_rule():
    g = [torch.tensor([6.0, 8.0])]                # norm exactly 10: clipped
    tstate.clip_by_global_norm(g, tstate.global_norm(g))
    assert torch.allclose(g[0], torch.tensor([6.0, 8.0]))
    g = [torch.tensor([3.0, 4.0])]                # norm 5: unchanged
    tstate.clip_by_global_norm(g, tstate.global_norm(g))
    assert torch.equal(g[0], torch.tensor([3.0, 4.0]))
    g = [torch.tensor([30.0, 40.0])]              # norm 50: scaled to 10
    tstate.clip_by_global_norm(g, tstate.global_norm(g))
    assert torch.allclose(g[0], torch.tensor([6.0, 8.0]))


# -- the grad_method repair ---------------------------------------------------

def small_batch(seed, B=1, H=54, W=54):
    rng = np.random.RandomState(seed)
    b = {"left": torch.from_numpy(rng.randn(B, 3, H, W).astype(np.float32)),
         "right": torch.from_numpy(rng.randn(B, 3, H, W).astype(np.float32)),
         "gt": torch.from_numpy((rng.rand(B, H, W) * 40).astype(np.float32))}
    for side in ("left_masks", "right_masks"):
        b[side] = [torch.from_numpy((rng.rand(B, H // s, W // s) < 0.3)
                                    .astype(np.float32)) for s in (9, 3, 1)]
    return b


@pytest.mark.parametrize("grad_method", ["detach", "undetach"])
def test_grad_method_detaches_the_dense_branch(grad_method):
    """Stage 2's dense term reaches the stage-0 regulariser only through
    the upsampled coarser prediction: no gradient under "detach" (the JAX
    model's stop_gradient), some under "undetach"."""
    torch.manual_seed(0)
    cfg = tconfig.ModelConfig(**{**FAITHFUL_SMALL, "grad_method": grad_method},
                              dtype="float32")
    model = DecNet(cfg).train()
    b = small_batch(5)
    out = model(b["left"], b["right"], b["left_masks"], b["right_masks"])
    dense = out["dense"][1]
    grads = torch.autograd.grad(dense.sum(), list(model.cost_reg.parameters()),
                                allow_unused=True)
    norm = sum(float(g.abs().sum()) for g in grads if g is not None)
    if grad_method == "detach":
        assert norm == 0.0
    else:
        assert norm > 0.0
    assert not out["var"][1].requires_grad      # the variance: never
    with pytest.raises(ValueError):
        tconfig.ModelConfig(grad_method="other")


# -- config -------------------------------------------------------------------

def test_full_config_loader_and_overrides():
    cfg = tconfig.load_full_config(CKPT, ["train.batch_size=2",
                                          "model.max_disp=54",
                                          "loss.weights=1,1,1,0.5"])
    with open(os.path.join(CKPT, "config.json")) as f:
        raw = json.load(f)
    assert cfg.train.batch_size == 2 and cfg.model.max_disp == 54
    assert cfg.loss.weights == (1, 1, 1, 0.5)
    for k in ("lr", "lr_schedule", "warmup_steps", "total_steps", "crop_h",
              "crop_w", "freeze_bn_after", "seed"):
        assert getattr(cfg.train, k) == raw["train"][k], k
    for k in ("sparse_term_scale", "sparse_cand_mask", "down_func_name"):
        assert getattr(cfg.loss, k) == raw["loss"][k], k
    assert cfg.model.grad_method == "detach" and cfg.data.on_device
    # what the JAX package reads back from the port's dict
    JaxConfig.from_dict(cfg.to_dict())
    with pytest.raises(NotImplementedError):
        tconfig.load_full_config(CKPT, ["mesh.tile=2"])
    # packed_exec is ported (tests/test_torch_repack.py)
    assert tconfig.load_full_config(
        CKPT, ["train.packed_exec=1"]).train.packed_exec
    # every loss type is ported (tests/test_torch_losses.py)
    assert tconfig.load_full_config(
        CKPT, ["loss.loss_type=chamfer"]).loss.loss_type == "chamfer"
    # the three stream variants are ported; any other name is an error
    for v in ("stressor", "legacy"):
        assert tconfig.load_full_config(
            CKPT, [f"data.variant={v}"]).data.variant == v
    with pytest.raises(ValueError):
        tconfig.load_full_config(CKPT, ["data.variant=nosuch"])
    with pytest.raises(KeyError):
        tconfig.load_full_config(CKPT, ["train.no_such_key=1"])


# -- checkpoints --------------------------------------------------------------

def test_reverse_bridge_is_bit_identical(tmp_path):
    model = f32_model(CKPT)
    arrays = flax_arrays_from_model(model)
    with np.load(os.path.join(CKPT, "params.npz")) as z:
        assert set(arrays) == set(z.files)
        for k in z.files:
            assert arrays[k].dtype == z[k].dtype, k
            np.testing.assert_array_equal(arrays[k], z[k], err_msg=k)
    # JAX's load_params reads the port's snapshot onto its model template
    cfg = tconfig.load_full_config(CKPT)
    path = tckpt.save_params(str(tmp_path), model, cfg)
    with open(os.path.join(CKPT, "config.json")) as f:
        mcfg = json.load(f)["model"]
    mcfg.update(dtype="float32", matching_impl="xla")
    x = np.zeros((1, 54, 54, 3), np.float32)
    m = [np.zeros((1, 54 // s, 54 // s), np.float32) for s in (9, 3, 1)]
    tmpl = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  template(JaxModelConfig(**mcfg), x, x, m, m))
    loaded = jckpt.load_params(path, tmpl)
    n = 0
    for key, leaf in jax.tree_util.tree_flatten_with_path(loaded)[0]:
        k = "/".join(str(p) for p in key)
        np.testing.assert_array_equal(np.asarray(leaf), arrays[k])
        n += 1
    assert n == 374
    # and the port's loader reads it back
    back = f32_model(str(tmp_path))
    for k, v in back.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    assert json.load(open(os.path.join(tmp_path, "config.json")))["model"][
        "max_disp"] == 216


# -- the train CLI ------------------------------------------------------------

TINY = ["--set", "model.max_disp=27", "--set", "model.base_channels=4",
        "--set", "model.dtype=float32", "--set", "train.batch_size=1",
        "--set", "train.crop_h=54", "--set", "train.crop_w=54",
        "--set", "train.log_every=1", "--set", "train.freeze_bn_after=2"]


def test_train_cli_on_cpu(tmp_path, capsys):
    argv = ["--config", os.path.join(CKPT, "config.json"), "--dataset",
            "synthetic", "--ckpt_dir", str(tmp_path), "--steps", "3",
            "--device", "cpu", "--eval_split", "val", "--eval_every", "2",
            "--eval_batches", "1"] + TINY
    run = tcli.prepare(argv)
    before = {k: v.clone() for k, v in run.state.model.state_dict().items()}
    tcli.run(run)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    steps = [l for l in lines if "loss" in l]
    evals = [l for l in lines if "eval_epe" in l]
    assert [l["step"] for l in steps] == [1, 2, 3]
    for l in steps:
        assert {"loss", "grad_norm", "steps_per_sec", "stage0/pred",
                "stage3/sparse"} <= set(l)
        assert all(np.isfinite(v) for v in l.values())
    assert len(evals) == 1 and evals[0]["step"] == 2
    assert {"eval_epe", "eval_d1", "eval_epe_up0", "eval_d1_up0"} <= \
        set(evals[0])
    assert run.state.step == 3
    after = run.state.model.state_dict()
    moved = [k for k in after if not torch.equal(after[k], before[k])]
    assert any(k.endswith("conv.weight") for k in moved)
    assert any(k.endswith("running_mean") for k in moved)
    # the snapshot is the final state
    back = f32_model(str(tmp_path))
    for k, v in back.state_dict().items():
        assert torch.equal(v, after[k]), k


def test_freeze_bn_step_keeps_statistics():
    """Past freeze_bn_after the step normalises with the running
    statistics: they stay bit-identical while the parameters move."""
    argv = ["--dataset", "synthetic", "--device", "cpu", "--steps", "5",
            "--set", "data.on_device=1", "--set", "train.warmup_steps=1"] \
        + TINY
    run = tcli.prepare(argv)
    for _ in range(2):
        assert not run.freeze_bn()
        run.step(next(run.stream))
    assert run.freeze_bn()
    sd = {k: v.clone() for k, v in run.state.model.state_dict().items()}
    logs = run.step(next(run.stream))
    assert np.isfinite(float(logs["total"]))
    after = run.state.model.state_dict()
    for k, v in sd.items():
        if k.endswith(("running_mean", "running_var")):
            assert torch.equal(after[k], v), k
    assert any(not torch.equal(after[k], v) for k, v in sd.items()
               if k.endswith("conv.weight"))


def test_train_cli_refuses_unported_data(tmp_path):
    """The datasets' files are read (tests/test_torch_eval_cli.py trains
    from them, baseline JPEG included); what stays refused is progressive
    JPEG (ROADMAP.md section 3), raised from the loader's worker in the
    step's stream, and an on-device stream of a dataset that is not
    synthetic."""
    import cv2
    from tests.test_torch_datasets import write_drivingstereo
    write_drivingstereo(str(tmp_path))
    for side in ("left-image", "right-image"):
        d = tmp_path / "train" / side
        for f in os.listdir(d):
            img = cv2.imread(str(d / f))
            os.remove(d / f)
            cv2.imwrite(str(d / f.replace(".png", ".jpg")), img,
                        [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    run = tcli.prepare(["--dataset", "drivingstereo", "--root",
                        str(tmp_path), "--device", "cpu", "--ckpt_dir",
                        str(tmp_path / "run"), "--set",
                        "data.on_device=false"] + TINY)
    with pytest.raises(NotImplementedError, match="progressive"):
        next(run.stream)
    with pytest.raises(ValueError, match="on_device"):
        tcli.prepare(["--dataset", "sceneflow", "--device", "cpu", "--set",
                      "data.on_device=true"])
