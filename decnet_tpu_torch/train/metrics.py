"""Evaluation metrics — the port of decnet_tpu/train/metrics.py: EPE and
the 3 px / 5% error rate, per batch or per sample."""
from __future__ import annotations

from typing import List, Sequence, Tuple

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


def per_sample_epe_d1(pred: torch.Tensor, gt: torch.Tensor,
                      n_disps: Sequence[int]
                      ) -> Tuple[List[float], List[float]]:
    """`epe_and_d1` of each sample of a batch over its own valid range
    0 < gt < n_disps[i] (the eval CLI's per-scene ndisp; a batch's forward
    runs at the largest)."""
    epes, d1s = [], []
    for i, nd in enumerate(n_disps):
        epe, d1 = epe_and_d1(pred[i:i + 1], gt[i:i + 1], nd)
        epes.append(float(epe))
        d1s.append(float(d1))
    return epes, d1s
