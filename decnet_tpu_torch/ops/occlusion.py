"""Occlusion from disparity — the port of decnet_tpu/ops/occlusion.py
(reference utils/utils.py:158-208 `get_occ`).

With shift(x) = x - d(x), a left pixel is occluded when some pixel to its
right lands at or left of it, shift(x) > min over x' >= x of shift(x'), or
when it lands outside the image, shift(x) <= 0: one reversed cumulative
minimum."""
from __future__ import annotations

import torch


def occlusion_mask(disparity: torch.Tensor) -> torch.Tensor:
    """disparity (B,H,W) -> bool (B,H,W), True where occluded."""
    W = disparity.shape[-1]
    xs = torch.arange(W, dtype=disparity.dtype, device=disparity.device)
    shift = xs - disparity
    suffix_min = torch.flip(torch.cummin(torch.flip(shift, [2]), 2).values,
                            [2])
    return (shift > suffix_min) | (shift <= 0)
