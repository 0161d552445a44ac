"""Masked sparse stereo matching and its variance, forward only — the port
of decnet_tpu/ops/matching.py:115-134 and :384-409.

For each left pixel with ref_mask != 0 the disparity band of right pixels
with tar_mask != 0 is scored by a feature dot product; the output is the
softmax-weighted expected disparity and the variance around it, from one
pass of `ops/kernels/spamat.moments`.  EPS semantics follow the reference
(SM_kernel.cu:45, :100-124): the max is clamped to >= 1e-6 and both
accumulators carry +1e-6, so a query with no candidate outputs exactly 1.0.
Features are NCHW, masks (B,H,W).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from decnet_tpu_torch.ops.kernels import spamat
from decnet_tpu_torch.ops.kernels.spamat import EPS


def candidate_availability(tar_mask: torch.Tensor,
                           max_disp: int) -> torch.Tensor:
    """1.0 where the band [x - max_disp + 1, x] holds a right pixel with
    tar_mask != 0, else 0.0: a trailing-window max, (B,H,W) f32."""
    B, H, W = tar_mask.shape
    m = (tar_mask != 0).float().reshape(B * H, 1, W)
    m = F.max_pool1d(F.pad(m, (max_disp - 1, 0)), max_disp, stride=1)
    return m.reshape(B, H, W)


def sparse_matching_with_var(ref: torch.Tensor, tar: torch.Tensor,
                             ref_mask: torch.Tensor, tar_mask: torch.Tensor,
                             max_disp: int,
                             moments: Callable = spamat.moments,
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(expected disparity, variance), each (B,H,W) f32, zero where
    ref_mask == 0.  The variance uses the moment identity
    sum e (d - out)^2 = sed2 - 2 out sed + out^2 se.

    `moments` is the function that computes the moments: the kernel
    wrapper by default, `spamat.moments_plain` to hold the kernel path
    against the plain one on a card."""
    _, se, sed, sed2 = moments(ref, tar, ref_mask, tar_mask, max_disp)
    refm = ref_mask != 0
    out = torch.where(refm, (EPS + sed) / (EPS + se), 0.0)
    svar = sed2 - 2.0 * out * sed + out * out * se
    var = torch.where(refm, (EPS + svar) / (EPS + se), 0.0)
    return out, var
