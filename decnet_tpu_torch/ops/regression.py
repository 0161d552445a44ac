"""Disparity hypotheses and soft-argmin — the port of
decnet_tpu/ops/regression.py: the uniform set of stage 0, the adaptive set
around a prior (reference submodule.py:398-411; no forward of the shipped
model reaches it, the reference CLI exposes it) and the regression."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def uniform_disp_samples(max_disp: int, batch: int, height: int, width: int,
                         device=None) -> torch.Tensor:
    """arange(max_disp) broadcast to (B,S,H,W), f32."""
    d = torch.arange(max_disp, dtype=torch.float32, device=device)
    return d[None, :, None, None].expand(batch, max_disp, height, width)


def adaptive_disp_samples(disparity: torch.Tensor, max_disp: int,
                          step: float, samp_num: int,
                          kernel_size: int) -> torch.Tensor:
    """`samp_num` hypotheses per pixel spaced evenly between the min and
    max of the prior `disparity` (B,H,W) over a kernel_size window (its
    outside ignored), the range first widened to samp_num * step about its
    middle and cut to [0, max_disp]; (B,samp_num,H,W)."""
    pad = (kernel_size - 1) // 2
    x = disparity[:, None]
    upper = F.max_pool2d(x, kernel_size, 1, pad)[:, 0]
    lower = torch.abs(-F.max_pool2d(-x, kernel_size, 1, pad)[:, 0])
    modified = torch.clamp(samp_num * step - (upper - lower), min=0) / 2
    lower = torch.clamp(lower - modified, 0, max_disp)
    upper = torch.clamp(upper + modified, 0, max_disp)
    new_step = (upper - lower) / (samp_num - 1)
    idx = torch.arange(samp_num, dtype=disparity.dtype,
                       device=disparity.device)[None, :, None, None]
    return lower[:, None] + idx * new_step[:, None]


def disparity_regression(cost: torch.Tensor,
                         disp_samples: torch.Tensor) -> torch.Tensor:
    """Softmax over S, then the expected disparity: (B,S,H,W) -> (B,H,W),
    in f32 whatever the cost's dtype."""
    p = torch.softmax(cost.float(), dim=1)
    return (p * disp_samples.float()).sum(dim=1)
