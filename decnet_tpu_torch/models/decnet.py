"""DecNet, the faithful (reference-form) model, forward for serving and
training — the port of decnet_tpu/models/decnet.py:125-376 for
use_detail=False, s2d_fine=False.

Per forward pass:
  stage 0 (1/27): uniform warped `cor` cost volume -> 3D-conv regulariser
                  -> soft-argmin disparity;
  stages 1..3:    dynamic upsampling of the coarser prediction (dense
                  branch); sparse matching plus variance on the detail
                  pixels given by the masks (sparse branch, the
                  `spamat_moments` kernel, and in training the `spamat_dref`
                  and `spamat_dtar` kernels); soft-attention fusion;
                  residual refinement (the `warp` kernel).
Under grad_method "detach" the coarser prediction enters the dynamic
upsampling without gradient, and the variance never carries one (the
reference computes it under no_grad).  Batch norm follows the module's
train/eval mode.  Inputs are NCHW; the output dict has the JAX model's
keys.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from decnet_tpu_torch.config import ModelConfig
from decnet_tpu_torch.nn.feature import FeatureExtractor
from decnet_tpu_torch.nn.heads import (CostRegNet, DynamicUpsampling,
                                       Refinement, SoftAttention)
from decnet_tpu_torch.ops.cost_volume import build_cost_volume_uniform
from decnet_tpu_torch.ops.kernels import warp as warp_kernel
from decnet_tpu_torch.ops.matching import (candidate_availability,
                                           sparse_matching_with_var)
from decnet_tpu_torch.ops.regression import (disparity_regression,
                                             uniform_disp_samples)

OUTPUT_KEYS = ("preds", "dense", "sparse", "sparse_raw", "fusion",
               "soft_mask", "var", "residual", "masks_used", "cand")


class DecNet(nn.Module):
    """The faithful DecNet.  Module and parameter names follow the flax
    model's (`feature_extractor`, `cost_reg`, `dyn_up_i`, `soft_att_i`,
    `refine_i`, `match_logt_i`), so `weights.py` maps checkpoints by name.

    `use_kernels` (default True) sends the sparse matching (forward and
    backward) and the Refinement warp through the kernel wrappers; False
    runs their plain PyTorch versions on any device, which is how a card
    run holds the kernel path against the plain one."""

    def __init__(self, cfg: ModelConfig, use_kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = use_kernels
        dtype = cfg.torch_dtype
        s, ns = cfg.down_scale, cfg.num_stage
        self.feature_extractor = FeatureExtractor(cfg.base_channels, s,
                                                  dtype=dtype)
        chans = self.feature_extractor.out_channels
        self.cost_reg = CostRegNet(chans[0], dtype=dtype)
        for stage in range(1, ns):
            c, i = chans[stage], stage - 1
            self.add_module(f"dyn_up_{i}",
                            DynamicUpsampling(c, s, dtype=dtype))
            self.add_module(f"soft_att_{i}",
                            SoftAttention(c + 4, cfg.base_channels,
                                          dtype=dtype))
            self.add_module(f"refine_{i}",
                            Refinement(c, stage_id=stage, dtype=dtype))
            if cfg.match_temp_learned:
                self.register_parameter(
                    f"match_logt_{i}",
                    nn.Parameter(torch.tensor(math.log(cfg.match_temp))))

    def _temperature(self, i: int) -> Optional[torch.Tensor]:
        cfg = self.cfg
        if cfg.match_temp_learned:
            return torch.exp(getattr(self, f"match_logt_{i}"))
        if cfg.match_temp != 1.0:
            return torch.tensor(cfg.match_temp, dtype=torch.float32)
        return None

    def forward(self, left: torch.Tensor, right: torch.Tensor,
                left_masks: Sequence[torch.Tensor],
                right_masks: Sequence[torch.Tensor],
                max_disp: Optional[int] = None
                ) -> Dict[str, List[torch.Tensor]]:
        """left/right (B,3,H,W) normalised images, H and W divisible by 27;
        masks: per fine stage, coarsest first, (B,h_s,w_s) in {0,1}.
        `max_disp` may be overridden per call (a scene's disparity range)."""
        cfg = self.cfg
        dtype = cfg.torch_dtype
        scale, ns = cfg.down_scale, cfg.num_stage
        max_disp = int(max_disp or cfg.max_disp)
        warp = functools.partial(warp_kernel.warp_with_grad,
                                 use_kernel=self.use_kernels)

        left_all = self.feature_extractor(left.to(dtype))
        right_all = self.feature_extractor(right.to(dtype))
        out: Dict[str, List[torch.Tensor]] = {k: [] for k in OUTPUT_KEYS}

        lf, rf = left_all[0], right_all[0]
        d0 = max_disp // scale ** (ns - 1)
        B, _, H, W = lf.shape
        vol = build_cost_volume_uniform(lf, rf, d0, cfg.cost_func)
        cost = self.cost_reg(vol)
        pred = disparity_regression(
            cost, uniform_disp_samples(d0, B, H, W, device=lf.device))
        out["preds"].append(pred)

        for stage in range(1, ns):
            i = stage - 1
            lf = left_all[stage].contiguous()
            rf = right_all[stage].contiguous()
            cur_max_disp = max_disp // scale ** (ns - stage - 1)
            lmask = left_masks[i].float().contiguous()
            rmask = right_masks[i].float().contiguous()
            out["masks_used"].append(lmask)

            cur = pred.detach() if cfg.grad_method == "detach" else pred
            dense = getattr(self, f"dyn_up_{i}")(cur, lf)
            out["dense"].append(dense)

            temp = self._temperature(i)
            q = lf if temp is None else (lf.float() * temp).to(lf.dtype)
            cand = candidate_availability(rmask, cur_max_disp)
            out["cand"].append(cand)
            sparse, var = sparse_matching_with_var(
                q.contiguous(), rf, lmask, rmask, cur_max_disp,
                use_kernel=self.use_kernels)
            var = var.detach()
            out["sparse_raw"].append(sparse)
            if cfg.cand_fallback:
                sparse = torch.where(cand > 0, sparse, dense)
            out["sparse"].append(sparse)
            out["var"].append(var)

            att_in = torch.cat([lf] + [x[:, None].to(dtype) for x in
                                       (dense, sparse, lmask, -var)], dim=1)
            soft = getattr(self, f"soft_att_{i}")(att_in)
            out["soft_mask"].append(soft)

            fused = dense * (1.0 - soft) + soft * sparse
            out["fusion"].append(fused)

            pred, residual = getattr(self, f"refine_{i}")(
                lf, rf, fused, cur_max_disp, warp=warp)
            out["residual"].append(residual)
            out["preds"].append(pred)
        return out
