"""Stage-0 cost volume — the port of decnet_tpu/ops/cost_volume.py:46-68
for the `cor` cost (the shipped default)."""
from __future__ import annotations

import torch

from decnet_tpu_torch.ops.warp import warp_volume_uniform


def build_cost_volume_uniform(left: torch.Tensor, right: torch.Tensor,
                              max_disp: int,
                              cost_func: str = "cor") -> torch.Tensor:
    """left/right (B,C,H,W) -> (B,C,S,H,W) for d = 0..max_disp-1: the left
    features times the right features warped by d, with the left entries
    zeroed where d > x (reference submodule.py:507)."""
    if cost_func != "cor":
        raise NotImplementedError(f"cost_func {cost_func!r} is not ported")
    W = left.shape[-1]
    right_vol = warp_volume_uniform(right, max_disp)
    in_range = (torch.arange(W, device=left.device)[None, :]
                >= torch.arange(max_disp, device=left.device)[:, None])
    left_vol = left[:, :, None] * in_range[:, None, :].to(left.dtype)
    return left_vol * right_vol
