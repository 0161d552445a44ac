"""Uniform disparity hypotheses and soft-argmin — the port of
decnet_tpu/ops/regression.py:15-22 and :57-65."""
from __future__ import annotations

import torch


def uniform_disp_samples(max_disp: int, batch: int, height: int, width: int,
                         device=None) -> torch.Tensor:
    """arange(max_disp) broadcast to (B,S,H,W), f32."""
    d = torch.arange(max_disp, dtype=torch.float32, device=device)
    return d[None, :, None, None].expand(batch, max_disp, height, width)


def disparity_regression(cost: torch.Tensor,
                         disp_samples: torch.Tensor) -> torch.Tensor:
    """Softmax over S, then the expected disparity: (B,S,H,W) -> (B,H,W),
    in f32 whatever the cost's dtype."""
    p = torch.softmax(cost.float(), dim=1)
    return (p * disp_samples.float()).sum(dim=1)
