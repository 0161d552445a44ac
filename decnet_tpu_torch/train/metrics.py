"""Evaluation metrics — the port of decnet_tpu/train/metrics.py: EPE and
the 3 px / 5% error rate."""
from __future__ import annotations

from typing import Tuple

import torch


def epe_and_d1(pred: torch.Tensor, gt: torch.Tensor, max_disp: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(epe, d1): mean |pred - gt| over 0 < gt < max_disp, and the
    percentage of those pixels whose error is >= 3 px and >= 5% of gt."""
    valid = (gt > 0) & (gt < max_disp)
    err = (pred - gt).abs()
    cnt = valid.sum().clamp(min=1)
    epe = torch.where(valid, err, 0.0).sum() / cnt
    ok = (err < 3.0) | (err < 0.05 * gt)
    d1 = 100.0 - (valid & ok).sum() / cnt * 100.0
    return epe, d1
