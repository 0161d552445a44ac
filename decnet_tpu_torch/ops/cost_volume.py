"""Cost volumes — the port of decnet_tpu/ops/cost_volume.py: the general
`build_cost_volume` for per-pixel disparity hypotheses and the stage-0
`build_cost_volume_uniform` for d = 0..max_disp-1, each with the
reference's three costs (submodule.py:479-562):

  cor  the product of the left and the warped right features (C channels);
  cat  the two concatenated, left first (2C channels);
  ssd  (l^2 + r^2) / 2 - ((l + r) / 2)^2 (C channels).

The left entries whose hypothesis points left of the image (d > x) are
zeroed before the cost (reference submodule.py:507).  Volumes are
(B,C,S,H,W)."""
from __future__ import annotations

import torch

from decnet_tpu_torch.ops.warp import (warp_volume_by_disparity,
                                       warp_volume_uniform)


def _cost(left_vol: torch.Tensor, right_vol: torch.Tensor,
          cost_func: str) -> torch.Tensor:
    if cost_func == "cor":
        return left_vol * right_vol
    if cost_func == "cat":
        return torch.cat([left_vol, right_vol], dim=1)
    if cost_func == "ssd":
        s = left_vol + right_vol
        return (left_vol ** 2 + right_vol ** 2) / 2.0 - (s / 2.0) ** 2
    raise ValueError(f"unknown cost_func {cost_func}")


def build_cost_volume(left: torch.Tensor, right: torch.Tensor,
                      disp_samples: torch.Tensor,
                      cost_func: str = "cor") -> torch.Tensor:
    """left/right (B,C,H,W), disp_samples (B,S,H,W) -> (B,C[*2],S,H,W):
    the right features sampled at x - d (`warp_volume_by_disparity`, f32)
    against the left ones, zeroed where x < d."""
    W = left.shape[-1]
    right_vol = warp_volume_by_disparity(right, disp_samples)
    xs = torch.arange(W, dtype=disp_samples.dtype, device=left.device)
    in_range = (xs >= disp_samples)[:, None]                # (B,1,S,H,W)
    left_vol = left[:, :, None] * in_range.to(left.dtype)
    return _cost(left_vol, right_vol, cost_func)


def build_cost_volume_uniform(left: torch.Tensor, right: torch.Tensor,
                              max_disp: int, cost_func: str = "cor",
                              start: int = 0,
                              count: int = None) -> torch.Tensor:
    """left/right (B,C,H,W) -> (B,C[*2],S,H,W) for d = 0..max_disp-1, the
    right volume by `warp_volume_uniform` in the features' dtype.  With
    `start` and `count`, only the hypotheses start .. start + count - 1: a
    disp rank's slice of S, built from the whole features with no
    communication."""
    W = left.shape[-1]
    count = max_disp - start if count is None else count
    right_vol = warp_volume_uniform(right, max_disp, start, count)
    in_range = (torch.arange(W, device=left.device)[None, :]
                >= torch.arange(start, start + count,
                                device=left.device)[:, None])
    left_vol = left[:, :, None] * in_range[:, None, :].to(left.dtype)
    return _cost(left_vol, right_vol, cost_func)
