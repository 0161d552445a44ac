"""The training loss — the port of decnet_tpu/train/loss.py:23-103
(masked_mean, smooth_l1, gt_pyramid, multi_stage_uploss: the reference's
multi_stage_regression_Uploss).  Maps are (B,H,W)."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from decnet_tpu_torch.config import LossConfig
from decnet_tpu_torch.ops.resize import downsample_gt


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over mask != 0; 0 when the mask is empty."""
    m = mask.float()
    cnt = m.sum()
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
            sky = torch.arange(cur_gt.shape[1], device=gt.device) \
                < int(108 // down)
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
