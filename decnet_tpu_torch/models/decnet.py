"""DecNet forward for serving and training — the port of
decnet_tpu/models/decnet.py:47-376 for the faithful model with 1 to 4
stages, the `cor`, `cat` and `ssd` costs, batch or group norm, the bicubic
skip of fine stages, its learned detail heads (`use_detail`), the
space-to-depth twins of the full-resolution stage (`s2d_fine`, s2d_stages
1) and of the 1/3-res stage too (s2d_stages 2), and the prior-windowed
matching (`match_window`).

Per forward pass (four stages; with fewer, stage 0 is at 1/3^(ns-1)):
  stage 0 (1/27): uniform warped cost volume -> 3D-conv regulariser
                  -> soft-argmin disparity;
  stages >= skip_stage_id: the previous prediction times the scale,
                  upsampled bicubically, and no head runs (the reference's
                  Middlebury full-resolution setting);
  other stages 1..3: detail masks, from the caller or from the learned heads
                  (binarised, `binarise_detail_pair`); dynamic upsampling
                  of the coarser prediction (dense branch); sparse matching
                  plus variance on the detail pixels (sparse branch, the
                  `spamat_moments` kernel, windowed around the detached
                  dense prediction with match_window, and in training the
                  `spamat_dref` and `spamat_dtar` kernels); soft-attention
                  fusion; residual refinement (the `warp` kernel).
With s2d_fine the last stage (with s2d_stages 2 the last two) runs its
convolutions on s2d planes at 1/3 of its resolution (`...S2D` heads); the
matching and the warp see its features unpacked to the stage's own
resolution (`depth_to_space`), which is the data the JAX package's
rows-form kernels read, and so does the next stage's detail head.  Under grad_method "detach" the coarser
prediction enters the dynamic upsampling without gradient, and the
variance never carries one (the reference computes it under no_grad).
Batch norm follows the module's train/eval mode.  Inputs are NCHW; the
output dict has the JAX model's keys, s2d stages' maps as full planes.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from decnet_tpu_torch.config import ModelConfig
from decnet_tpu_torch.models.repack import packed_geometry
from decnet_tpu_torch.nn.feature import FeatureExtractor
from decnet_tpu_torch.nn.heads import (CostRegNet, DetailHead, DetailHeadS2D,
                                       DynamicUpsampling, Refinement,
                                       RefinementS2D, SoftAttention,
                                       SoftAttentionS2D)
from decnet_tpu_torch.nn.layers import (depth_to_space, norm_override,
                                        plane_to_s2d, s2d_to_plane)
from decnet_tpu_torch.ops.cost_volume import build_cost_volume_uniform
from decnet_tpu_torch.ops.kernels import warp as warp_kernel
from decnet_tpu_torch.ops.matching import (candidate_availability,
                                           candidate_availability_windowed,
                                           sparse_matching_with_var)
from decnet_tpu_torch.ops.regression import (disparity_regression,
                                             uniform_disp_samples)
from decnet_tpu_torch.ops.resize import interpolate

OUTPUT_KEYS = ("preds", "dense", "sparse", "sparse_raw", "fusion",
               "soft_mask", "var", "residual", "left_details",
               "right_details", "masks_used", "cand")


def quantile_linear(flat: torch.Tensor, q: float) -> torch.Tensor:
    """Per-row q-quantile of (B,N) f32 with linear interpolation, in the
    f32 arithmetic of `jnp.quantile`: pos = q (N - 1), the sorted values at
    floor(pos) and ceil(pos) weighted (1 - f, f), f = pos - floor(pos).  A
    sort, so no size limit (torch.quantile refuses inputs of more than 2^24
    elements)."""
    srt = torch.sort(flat.float(), dim=1).values
    n = flat.shape[1]
    pos = (torch.tensor(q, dtype=torch.float32)
           * torch.tensor(float(n - 1), dtype=torch.float32))
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    lo = int(low.clamp(0, n - 1))
    hi = int(high.clamp(0, n - 1))
    return srt[:, lo] * lw.to(flat.device) + srt[:, hi] * hw.to(flat.device)


def binarise_detail(detail: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Learned detail probabilities (B, ...) -> binary f32 mask, without
    gradient: detail > thold ("fixed"), or detail above each image's
    (1 - detail_density)-quantile over all its values ("quantile").  The
    cut is strict, so a tied map keeps nothing."""
    d = detail.detach().float()
    if cfg.thold_mode == "quantile":
        th = quantile_linear(d.reshape(d.shape[0], -1),
                             1.0 - cfg.detail_density)
        return (d > th.view((-1,) + (1,) * (d.dim() - 1))).float()
    return (d > cfg.thold).float()


def binarise_detail_pair(l_detail: torch.Tensor, r_detail: torch.Tensor,
                         cfg: ModelConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both views' masks; in quantile mode one threshold per pair, the
    quantile of the two views' values pooled."""
    if cfg.thold_mode != "quantile":
        return binarise_detail(l_detail, cfg), binarise_detail(r_detail, cfg)
    B = l_detail.shape[0]
    flat = torch.cat([l_detail.detach().reshape(B, -1),
                      r_detail.detach().reshape(B, -1)], dim=1)
    th = quantile_linear(flat, 1.0 - cfg.detail_density)

    def cut(d):
        t = th.view((-1,) + (1,) * (d.dim() - 1))
        return (d.detach().float() > t).float()
    return cut(l_detail), cut(r_detail)


HEAD_NAMES = ("detail", "dyn_up", "soft_att", "refine", "match_logt")


class DecNet(nn.Module):
    """DecNet.  Module and parameter names follow the flax model's
    (`feature_extractor`, `cost_reg`, `detail_i`, `dyn_up_i`, `soft_att_i`,
    `refine_i`, `match_logt_i`), so `weights.py` maps checkpoints by name.
    As in the flax model, a stage from `skip_stage_id` on has no heads.

    `use_kernels` (default True) sends the sparse matching (forward and
    backward) and the Refinement warp through the kernel wrappers; False
    runs their plain PyTorch versions on any device, which is how a card
    run holds the kernel path against the plain one."""

    def __init__(self, cfg: ModelConfig, use_kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = use_kernels
        with norm_override(cfg.norm):
            self._build(cfg)

    def _build(self, cfg: ModelConfig):
        dtype = cfg.torch_dtype
        s, ns = cfg.down_scale, cfg.num_stage
        self.feature_extractor = FeatureExtractor(
            cfg.base_channels, s, s2d_last=cfg.s2d_fine,
            s2d_mid=cfg.s2d_fine and cfg.s2d_stages >= 2, dtype=dtype,
            num_stage=ns)
        chans = self.feature_extractor.out_channels
        # each stage's channels unpacked: what the next detail head reads
        plain = [cfg.base_channels * s ** (ns - 1 - st) for st in range(ns)]
        self.cost_reg = CostRegNet(chans[0], cfg.cost_func, dtype=dtype)
        for stage in range(1, min(ns, cfg.skip_stage_id)):
            c, i = chans[stage], stage - 1
            if self._s2d(stage):
                # the packed twins keep the faithful stage's widths:
                # Refinement's is the stage's channels, SoftAttention's is
                # base_channels at every stage
                hidden = s * s * plain[stage]
                if cfg.use_detail:
                    self.add_module(f"detail_{i}", DetailHeadS2D(
                        plain[stage - 1], c, s, dtype=dtype))
                self.add_module(f"dyn_up_{i}", DynamicUpsampling(
                    c, s, pre_unfolded=True, out_s2d=True, dtype=dtype))
                self.add_module(f"soft_att_{i}", SoftAttentionS2D(
                    c + 4 * s * s, s, hidden=s * s * cfg.base_channels,
                    dtype=dtype))
                kern, dil = [3] * 7, [1] * 7
                for ci, d in zip((0, 2, 4), Refinement.DILATIONS[stage]):
                    kern[ci], dil[ci] = packed_geometry(d, s)
                self.add_module(f"refine_{i}", RefinementS2D(
                    2 * c + s * s, s, hidden=hidden, kernels=kern,
                    dilations=dil, dtype=dtype))
            else:
                if cfg.use_detail:
                    self.add_module(f"detail_{i}", DetailHead(
                        plain[stage - 1], c, dtype=dtype))
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

    def skipped_heads(self) -> Tuple[str, ...]:
        """Name prefixes ("refine_2.", ...) of the heads the fine stages
        from skip_stage_id on would have: a full checkpoint's arrays under
        them have no tensor here."""
        first = max(self.cfg.skip_stage_id, 1)
        return tuple(f"{h}_{stage - 1}" + ("" if h == "match_logt" else ".")
                     for stage in range(first, self.cfg.num_stage)
                     for h in HEAD_NAMES)

    def _s2d(self, stage: int) -> bool:
        """Whether fine stage `stage` runs in s2d form: the last
        `s2d_stages` stages with s2d_fine, never stage 0."""
        cfg = self.cfg
        return (cfg.s2d_fine and stage > 0
                and stage >= cfg.num_stage - cfg.s2d_stages)

    def _temperature(self, i: int) -> Optional[torch.Tensor]:
        cfg = self.cfg
        if cfg.match_temp_learned:
            return torch.exp(getattr(self, f"match_logt_{i}"))
        if cfg.match_temp != 1.0:
            return torch.tensor(cfg.match_temp, dtype=torch.float32)
        return None

    def forward(self, left: torch.Tensor, right: torch.Tensor,
                left_masks: Optional[Sequence[torch.Tensor]] = None,
                right_masks: Optional[Sequence[torch.Tensor]] = None,
                max_disp: Optional[int] = None,
                ablate_sparse: bool = False
                ) -> Dict[str, List[torch.Tensor]]:
        """left/right (B,3,H,W) normalised images, H and W divisible by 27;
        masks: per fine stage, coarsest first, (B,h_s,w_s) in {0,1} (not
        read with use_detail, whose heads make them).  `max_disp` may be
        overridden per call (a scene's disparity range); `ablate_sparse`
        fuses the dense branch alone (fused = dense), the ablation eval."""
        cfg = self.cfg
        dtype = cfg.torch_dtype
        scale, ns = cfg.down_scale, cfg.num_stage
        max_disp = int(max_disp or cfg.max_disp)
        warp = functools.partial(warp_kernel.warp_with_grad,
                                 use_kernel=self.use_kernels)

        left_all = self.feature_extractor(left.to(dtype))
        right_all = self.feature_extractor(right.to(dtype))
        out: Dict[str, List[torch.Tensor]] = {k: [] for k in OUTPUT_KEYS}
        out["left_feats"], out["right_feats"] = left_all, right_all

        lf, rf = left_all[0], right_all[0]
        d0 = max_disp // scale ** (ns - 1)
        B, _, H, W = lf.shape
        vol = build_cost_volume_uniform(lf, rf, d0, cfg.cost_func)
        cost = self.cost_reg(vol)
        pred = disparity_regression(
            cost, uniform_disp_samples(d0, B, H, W, device=lf.device))
        out["preds"].append(pred)
        pre_left, pre_right = lf, rf

        for stage in range(1, ns):
            i = stage - 1
            s2d = self._s2d(stage)
            lf, rf = left_all[stage], right_all[stage]
            if stage >= cfg.skip_stage_id:
                H, W = lf.shape[-2:]
                if s2d:
                    H, W = H * scale, W * scale
                pred = interpolate((pred * scale)[:, None], H, W,
                                   "bicubic")[:, 0]
                out["preds"].append(pred)
                continue
            # the matching and the warp read the stage's unpacked features
            lf_full = depth_to_space(lf, scale) if s2d else lf
            rf_full = depth_to_space(rf, scale) if s2d else rf
            lf_full, rf_full = lf_full.contiguous(), rf_full.contiguous()
            cur_max_disp = max_disp // scale ** (ns - stage - 1)

            if cfg.use_detail:
                head = getattr(self, f"detail_{i}")
                l_detail = torch.sigmoid(head(lf, pre_left))
                r_detail = torch.sigmoid(head(rf, pre_right))
                lmask, rmask = binarise_detail_pair(l_detail, r_detail, cfg)
                if s2d:
                    lmask_s2d = lmask
                    lmask, rmask = (s2d_to_plane(m, scale)
                                    for m in (lmask, rmask))
                    l_detail, r_detail = (s2d_to_plane(d, scale)
                                          for d in (l_detail, r_detail))
                out["left_details"].append(l_detail)
                out["right_details"].append(r_detail)
            else:
                lmask = left_masks[i].float()
                rmask = right_masks[i].float()
                if s2d:
                    lmask_s2d = plane_to_s2d(lmask, scale)
            lmask, rmask = lmask.contiguous(), rmask.contiguous()
            out["masks_used"].append(lmask)
            pre_left, pre_right = lf_full, rf_full

            cur = pred.detach() if cfg.grad_method == "detach" else pred
            dense = getattr(self, f"dyn_up_{i}")(cur, lf)
            dense_full = s2d_to_plane(dense, scale) if s2d else dense
            out["dense"].append(dense_full)

            temp = self._temperature(i)
            q = lf_full if temp is None else (
                lf_full.float() * temp).to(lf_full.dtype)
            win, center = 0, None
            if cfg.match_window > 0:
                win = max(2, round(cfg.match_window
                                   / scale ** (ns - 1 - stage)))
                center = dense_full.detach().float().contiguous()
                cand = candidate_availability_windowed(rmask, cur_max_disp,
                                                       center, win)
            else:
                cand = candidate_availability(rmask, cur_max_disp)
            out["cand"].append(cand)
            sparse, var = sparse_matching_with_var(
                q.contiguous(), rf_full, lmask, rmask, cur_max_disp, center,
                win, use_kernel=self.use_kernels)
            var = var.detach()
            out["sparse_raw"].append(sparse)
            if cfg.cand_fallback:
                sparse = torch.where(cand > 0, sparse, dense_full)
            out["sparse"].append(sparse)
            out["var"].append(var)

            if s2d:
                sparse_s2d = plane_to_s2d(sparse, scale)
                soft = getattr(self, f"soft_att_{i}")(
                    lf, [dense, sparse_s2d, lmask_s2d,
                         -plane_to_s2d(var, scale)])
                out["soft_mask"].append(s2d_to_plane(soft, scale))
                sparse = sparse_s2d
            else:
                att_in = torch.cat([lf] + [x[:, None].to(dtype) for x in
                                           (dense, sparse, lmask, -var)],
                                   dim=1)
                soft = getattr(self, f"soft_att_{i}")(att_in)
                out["soft_mask"].append(soft)

            fused = dense if ablate_sparse else (
                dense * (1.0 - soft) + soft * sparse)
            fused_full = s2d_to_plane(fused, scale) if s2d else fused
            out["fusion"].append(fused_full)

            if s2d:
                pred_s2d, residual = getattr(self, f"refine_{i}")(
                    lf, rf_full, fused, fused_full, cur_max_disp, warp=warp)
                pred = s2d_to_plane(pred_s2d, scale)
                residual = s2d_to_plane(residual, scale)
            else:
                pred, residual = getattr(self, f"refine_{i}")(
                    lf, rf_full, fused, cur_max_disp, warp=warp)
            out["residual"].append(residual)
            out["preds"].append(pred)
        return out
