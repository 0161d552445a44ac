"""Train and eval steps — the port of decnet_tpu/train/step.py:25-150, with
its loss dispatcher for every loss type and the detail mask term.

A batch is a dict: left/right (B,3,H,W) normalised images, gt (B,H,W)
(0 = invalid), left_masks/right_masks lists of per-fine-stage (B,h,w)
binary detail masks, coarsest first: the matching's masks when the model
has no detail heads, the heads' supervision targets when it has them (the
heads' own binarised maps then feed the matching)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from decnet_tpu_torch.config import Config
from decnet_tpu_torch.models.decnet import DecNet
from decnet_tpu_torch.ops.resize import interpolate
from decnet_tpu_torch.train import loss as loss_lib
from decnet_tpu_torch.train import state as state_lib
from decnet_tpu_torch.train.metrics import epe_and_d1


@dataclasses.dataclass
class TrainState:
    """The model (f32 parameters, compute in cfg.model.dtype), its
    optimizer, the schedule and the number of updates taken.  The schedule
    counts the optimizer's own updates, `step - schedule_from`: a params
    snapshot restores the step with a fresh optimizer, whose schedule
    starts again, as optax's count does."""
    model: DecNet
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    schedule_from: int = 0


def create_train_state(model: DecNet, cfg: Config) -> TrainState:
    model.float()        # f32 master parameters; units still compute in dtype
    return TrainState(model, state_lib.make_optimizer(model.parameters(),
                                                      cfg.train),
                      state_lib.make_schedule(cfg.train))


LOSS_TYPES = ("multi_stage_regression_uploss", "chamfer", "lr_consistency",
              "multi_stage_regression_upsampleloss",
              "multi_stage_regression_upmaskloss")
UPMASK = "multi_stage_regression_upmaskloss"


def check_loss_type(cfg: Config) -> str:
    """The configured loss type, lower-cased, after JAX's asserts: a known
    type; upmaskloss supervises learned detail heads; lr_consistency reads
    per-stage full-resolution features, so not the s2d form."""
    loss_type = cfg.loss.loss_type.lower()
    if loss_type not in LOSS_TYPES:
        raise ValueError(f"No such loss: {cfg.loss.loss_type}")
    if loss_type == UPMASK and not cfg.model.use_detail:
        raise ValueError("upmaskloss supervises the learned detail heads "
                         "(use_detail=1)")
    if loss_type == "lr_consistency" and cfg.model.s2d_fine:
        raise ValueError("lr_consistency reads per-stage NCHW feature maps "
                         "(not with s2d_fine)")
    return loss_type


def compute_loss(out: Dict, batch: Dict, cfg: Config
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss dispatcher: the configured loss type's total and terms;
    with learned detail heads and masks in the batch (any type but
    upmaskloss), plus alpha times the detail mask loss and its terms."""
    mcfg, lcfg = cfg.model, cfg.loss
    loss_type = check_loss_type(cfg)
    gt = batch["gt"]
    stages = (lcfg, mcfg.num_stage, mcfg.down_scale, mcfg.max_disp)
    if loss_type == "multi_stage_regression_uploss":
        total, logs = loss_lib.multi_stage_uploss(out, gt, *stages,
                                                  mcfg.skip_stage_id)
    elif loss_type == "chamfer":
        total, logs = loss_lib.multi_stage_chamfer(out, gt, *stages,
                                                   mcfg.skip_stage_id)
    elif loss_type == "multi_stage_regression_upsampleloss":
        total, logs = loss_lib.upsample_loss(out, gt, *stages)
    elif loss_type == "lr_consistency":
        total = loss_lib.lr_consistency_loss(
            out["preds"], out["left_feats"], out["right_feats"],
            lcfg.weights)
        logs = {"lr_consistency": total}
    else:
        return loss_lib.detail_mask_loss(
            out, batch["left_masks"], batch["right_masks"], lcfg.weights,
            binary_thold=lcfg.binary_thold)
    if mcfg.use_detail and batch.get("left_masks") is not None:
        mloss, mlogs = loss_lib.detail_mask_loss(
            out, batch["left_masks"], batch["right_masks"], lcfg.weights)
        total = total + lcfg.alpha * mloss
        logs.update(mlogs)
    return total, logs


def loss_and_grads(model: DecNet, batch: Dict, cfg: Config,
                   freeze_bn: bool = False, packed: Optional[Tuple] = None
                   ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """Forward (batch-stat BN, which updates the running stats, or with
    freeze_bn the running stats as eval uses them), the loss, backward.
    `packed` = (s2d twin, apply_fn) of `models/repack.py::repack_linear`
    runs the forward on the packed twin with the faithful model's tensors
    gathered into it (freeze_bn only: a packed BN would collect per-phase
    statistics).  Returns the logs (the loss terms and "total") and every
    parameter's gradient, zeros for a parameter the loss does not reach."""
    model.train(not freeze_bn)
    for p in model.parameters():
        p.grad = None
    args = (batch["left"], batch["right"], batch.get("left_masks"),
            batch.get("right_masks"))
    if packed is not None:
        if not freeze_bn:
            raise ValueError("training-mode repack requires freeze_bn "
                             "(packed BN batch statistics are per-phase)")
        twin, apply_fn = packed
        out = torch.func.functional_call(twin.eval(), apply_fn(model), args)
    else:
        out = model(*args)
    total, logs = compute_loss(out, batch, cfg)
    if total.requires_grad:
        total.backward()
    logs = {k: v.detach() for k, v in logs.items()}
    logs["total"] = total.detach()
    grads = []
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    return logs, grads


def train_step(state: TrainState, batch: Dict, cfg: Config,
               freeze_bn: bool = False, packed: Optional[Tuple] = None
               ) -> Dict[str, torch.Tensor]:
    """One update: loss and gradients (through the packed twin with
    `packed`, see `loss_and_grads`), `grad_norm` (of the unclipped
    gradients), the global-norm clip, then Adam at the scheduled rate.
    Returns the logs as device scalars (no host sync)."""
    logs, grads = loss_and_grads(state.model, batch, cfg, freeze_bn, packed)
    norm = state_lib.global_norm(grads)
    state_lib.clip_by_global_norm(grads, norm)
    state_lib.apply_updates(state.optimizer, state.schedule,
                            state.step - state.schedule_from)
    state.step += 1
    logs["grad_norm"] = norm.detach()
    return logs


@torch.no_grad()
def eval_step(model: DecNet, batch: Dict, cfg: Config
              ) -> Dict[str, torch.Tensor]:
    """epe and d1 of the final prediction, and epe_up0/d1_up0 of the
    stage-0 prediction upsampled bicubically to full size (the baseline the
    fine stages must beat)."""
    model.eval()
    out = model(batch["left"], batch["right"], batch["left_masks"],
                batch["right_masks"])
    gt = batch["gt"]
    pred = out["preds"][-1]
    epe, d1 = epe_and_d1(pred, gt, cfg.model.max_disp)
    coarse = out["preds"][0]
    H, W = gt.shape[1:]
    up = interpolate((coarse * (H / coarse.shape[1]))[:, None], H, W,
                     "bicubic")[:, 0]
    epe_up0, d1_up0 = epe_and_d1(up, gt, cfg.model.max_disp)
    return {"epe": epe, "d1": d1, "epe_up0": epe_up0, "d1_up0": d1_up0,
            "pred": pred}
