"""The training losses — the port of decnet_tpu/train/loss.py: masked_mean,
smooth_l1, gt_pyramid, multi_stage_uploss (the reference's
multi_stage_regression_Uploss), the detail mask loss (focal_loss,
mask_l1_loss, detail_mask_loss: multi_stage_regression_UpMaskloss),
upsample_loss, lr_consistency_loss and the chamfer loss (chamfer_error,
chamfer_loss, multi_stage_chamfer).  Maps are (B,H,W), features NCHW.

Every mean is over the global batch, as JAX's jitted step takes it: under
a process group each rank returns its share, its local sum over the
count all-reduced over data x tile (`parallel/mesh.py::global_sum`), and
the shares of the data x tile ranks sum to the loss of the whole batch
(each disp rank holds the same share).  On row shards the maps are this
rank's rows: the sky rows are counted from the image's top, and the
resizes and warps exchange halo rows."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from decnet_tpu_torch.config import LossConfig
from decnet_tpu_torch.ops.resize import downsample_gt, interpolate
from decnet_tpu_torch.ops.warp import warp_by_disparity, with_row_halo
from decnet_tpu_torch.parallel import mesh


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over mask != 0; 0 when the mask is empty.  Under a
    process group, this rank's share of the mean over every process's
    pixels: its sum over the global count (0 when that is 0)."""
    m = mask.float()
    cnt = mesh.global_sum(m.sum())
    return torch.where(cnt > 0, (x.float() * m).sum() / cnt.clamp(min=1.0),
                       0.0)


def smooth_l1(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth L1 with beta 1."""
    d = (pred - gt).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def gt_pyramid(gt: torch.Tensor, num_stage: int, down_scale: int,
               down_func_name: str) -> List[torch.Tensor]:
    """Per-stage ground truth, coarsest first, value-scaled."""
    gts = []
    for stage in range(num_stage):
        down = down_scale ** (num_stage - stage - 1)
        gts.append(gt if down == 1 else
                   downsample_gt(gt, down, down_func_name))
    return gts


def multi_stage_uploss(outputs: Dict, gt: torch.Tensor, cfg: LossConfig,
                       num_stage: int, down_scale: int, max_disp: int,
                       skip_stage_id: int = 4
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per stage: valid = 0 < gt_s < max_disp/down (and, with if_overmask,
    not a sky row); stage 0 (and skipped stages) smooth-L1 on pred; fine
    stages 0.5 pred + 0.1 dense + sparse_term_scale*0.2/(10+3.75 stage)
    sparse (on mask pixels, with a candidate when sparse_cand_mask) +
    0.2 fusion, all on disparities rescaled by down.  Returns the total and
    the terms under the JAX package's keys stage{s}/pred|dense|sparse|
    fusion."""
    preds = outputs["preds"]
    gts = gt_pyramid(gt, num_stage, down_scale, cfg.down_func_name)
    total = torch.zeros((), device=gt.device)
    logs: Dict[str, torch.Tensor] = {}
    fine_idx = 0
    for stage in range(num_stage):
        down = float(down_scale ** (num_stage - stage - 1))
        cur_gt = gts[stage]
        valid = (cur_gt > 0) & (cur_gt < max_disp / down)
        if cfg.if_overmask:
            row0, _ = mesh.rows_of(cur_gt.shape[1])
            sky = torch.arange(row0, row0 + cur_gt.shape[1],
                               device=gt.device) < int(108 // down)
            valid = valid & ~sky[None, :, None]
        w = cfg.weights[stage]

        def term(x, mask):
            return masked_mean(smooth_l1(x * down, cur_gt * down), mask)

        if stage == 0 or stage >= skip_stage_id:
            l = term(preds[stage], valid)
            total = total + w * l
            logs[f"stage{stage}/pred"] = l
            continue

        i = fine_idx
        fine_idx += 1
        whole = valid & (outputs["masks_used"][i] == 1)
        cand = outputs.get("cand")
        if cand and cfg.sparse_cand_mask:
            whole = whole & (cand[i] > 0)
        dense_l = term(outputs["dense"][i], valid)
        sparse_l = term(outputs["sparse"][i], whole)
        fusion_l = term(outputs["fusion"][i], valid)
        pred_l = term(preds[stage], valid)
        sparse_w = cfg.sparse_term_scale * 0.2 / (10.0 + 3.75 * stage)
        total = total + w * (0.5 * pred_l + 0.1 * dense_l
                             + sparse_w * sparse_l + 0.2 * fusion_l)
        logs[f"stage{stage}/pred"] = pred_l
        logs[f"stage{stage}/dense"] = dense_l
        logs[f"stage{stage}/sparse"] = sparse_l
        logs[f"stage{stage}/fusion"] = fusion_l
    return total, logs


def focal_loss(pt: torch.Tensor, gt: torch.Tensor, gamma: float = 2.0,
               alpha: float = 0.5) -> torch.Tensor:
    """Mean binary focal loss of probabilities `pt` against targets `gt`,
    in f32, with log(p + 1e-5) on both sides (this rank's share of the
    global batch's mean under a process group)."""
    pt, gt = pt.float(), gt.float()
    loss = (-alpha * (1 - pt) ** gamma * gt * torch.log(pt + 1e-5)
            - (1 - alpha) * pt ** gamma * (1 - gt) * torch.log(1 - pt + 1e-5))
    return mesh.global_mean(loss)


def mask_l1_loss(x: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Smooth L1 on the pixels where the target mask is > 0.1."""
    return masked_mean(smooth_l1(x, gt), gt > 0.1)


def detail_mask_loss(outputs: Dict, left_masks: Sequence[torch.Tensor],
                     right_masks: Sequence[torch.Tensor],
                     weights: Sequence[float],
                     binary_thold: Optional[float] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The learned detail maps (`left_details`/`right_details`) against the
    batch's masks, per fine stage i: (focal + 3 smooth-L1) of both views
    times weights[i].  `binary_thold` binarises the maps first.  Logs
    mask{i}/focal and mask{i}/l1, each summed over the two views."""
    total = torch.zeros((), device=left_masks[0].device)
    logs: Dict[str, torch.Tensor] = {}
    for i, (ld, rd) in enumerate(zip(outputs["left_details"],
                                     outputs["right_details"])):
        lm, rm = left_masks[i], right_masks[i]
        if binary_thold is not None:
            ld = (ld > binary_thold).float()
            rd = (rd > binary_thold).float()
        lfl, rfl = focal_loss(ld, lm), focal_loss(rd, rm)
        ll1, rl1 = mask_l1_loss(ld, lm), mask_l1_loss(rd, rm)
        total = total + (lfl + rfl + 3 * ll1 + 3 * rl1) * weights[i]
        logs[f"mask{i}/focal"] = lfl + rfl
        logs[f"mask{i}/l1"] = ll1 + rl1
    return total, logs


def upsample_loss(outputs: Dict, gt: torch.Tensor, cfg: LossConfig,
                  num_stage: int, down_scale: int, max_disp: int
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Every stage's prediction resized (`down_func_name`) to the full
    resolution, values times its down factor, smooth L1 against gt on
    0 < gt < max_disp; logs stage{s}/up."""
    H, W = gt.shape[1:]
    valid = (gt > 0) & (gt < max_disp)
    total = torch.zeros((), device=gt.device)
    logs: Dict[str, torch.Tensor] = {}
    for stage, pred in enumerate(outputs["preds"]):
        down = down_scale ** (num_stage - stage - 1)
        cur = pred if down == 1 else interpolate(
            (pred * down)[:, None], H, W, cfg.down_func_name)[:, 0]
        l = masked_mean(smooth_l1(cur, gt), valid)
        total = total + cfg.weights[stage] * l
        logs[f"stage{stage}/up"] = l
    return total, logs


def lr_consistency_loss(preds: Sequence[torch.Tensor],
                        left_feats: Sequence[torch.Tensor],
                        right_feats: Sequence[torch.Tensor],
                        weights: Sequence[float]) -> torch.Tensor:
    """Per stage, the right features warped by that stage's prediction
    (the plain unclipped `warp_by_disparity`) against the left ones: the
    squared difference summed over channels, averaged over pixels (of the
    global batch, see `parallel/mesh.py::global_mean`), times
    weights[stage].  Features are NCHW lists, coarsest first."""
    total = torch.zeros((), device=preds[0].device)
    for stage, pred in enumerate(preds):
        img, rows = with_row_halo(right_feats[stage])
        warped = warp_by_disparity(img, pred, rows)
        diff = (left_feats[stage].float() - warped.float()) ** 2
        total = total + weights[stage] * mesh.global_mean(diff.sum(dim=1))
    return total


def chamfer_error(pred: torch.Tensor, gt: torch.Tensor,
                  down_ratio: int) -> torch.Tensor:
    """Per coarse pixel, the distance from the prediction (full-resolution
    units) to the nearest valid (gt != 0) value of its down_ratio x
    down_ratio cell of gt, sqrt(min d^2 + 1e-6); invalid values are pushed
    away by 1e6.  pred (B,h,w), gt (B,h*r,w*r) -> (B,h,w)."""
    B, h, w = pred.shape
    r = down_ratio
    cells = gt.reshape(B, h, r, w, r).permute(0, 1, 3, 2, 4).reshape(
        B, h, w, r * r)
    d2 = (pred[..., None] - cells) ** 2 + torch.where(cells == 0, 1e6, 0.0)
    return torch.sqrt(d2.amin(dim=-1) + 1e-6)


def chamfer_loss(pred: torch.Tensor, gt: torch.Tensor, down_ratio: int,
                 extra_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Huber (delta 1) of the chamfer error, averaged over pixels with an
    error below 100 (and extra_mask == 1 when given)."""
    err = chamfer_error(pred, gt, down_ratio)
    mask = err < 100
    if extra_mask is not None:
        mask = mask & (extra_mask == 1)
    huber = torch.where(err < 1.0, 0.5 * err * err, err - 0.5)
    return masked_mean(huber, mask)


def multi_stage_chamfer(outputs: Dict, gt: torch.Tensor, cfg: LossConfig,
                        num_stage: int, down_scale: int, max_disp: int,
                        skip_stage_id: int = 4
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The chamfer loss type: every branch's chamfer loss against the
    full-resolution gt through its down_ratio cells, combined per stage as
    `multi_stage_uploss` does (the sparse term gated by the mask used);
    logs stage{s}/pred|dense|sparse|fusion."""
    preds = outputs["preds"]
    total = torch.zeros((), device=gt.device)
    logs: Dict[str, torch.Tensor] = {}
    fine_idx = 0
    for stage in range(num_stage):
        down = down_scale ** (num_stage - stage - 1)
        w = cfg.weights[stage]
        if stage == 0 or stage >= skip_stage_id:
            l = chamfer_loss(preds[stage] * down, gt, down)
            total = total + w * l
            logs[f"stage{stage}/pred"] = l
            continue
        i = fine_idx
        fine_idx += 1
        dense_l = chamfer_loss(outputs["dense"][i] * down, gt, down)
        sparse_l = chamfer_loss(outputs["sparse"][i] * down, gt, down,
                                extra_mask=outputs["masks_used"][i])
        fusion_l = chamfer_loss(outputs["fusion"][i] * down, gt, down)
        pred_l = chamfer_loss(preds[stage] * down, gt, down)
        sparse_w = cfg.sparse_term_scale * 0.2 / (10.0 + 3.75 * stage)
        total = total + w * (0.5 * pred_l + 0.1 * dense_l
                             + sparse_w * sparse_l + 0.2 * fusion_l)
        logs[f"stage{stage}/pred"] = pred_l
        logs[f"stage{stage}/dense"] = dense_l
        logs[f"stage{stage}/sparse"] = sparse_l
        logs[f"stage{stage}/fusion"] = fusion_l
    return total, logs
