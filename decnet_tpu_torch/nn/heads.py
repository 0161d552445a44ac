"""Per-stage heads of the faithful DecNet — the port of decnet_tpu/nn/
heads.py:20-139: cost regularisation, dynamic upsampling, soft attention and
refinement."""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn as nn

from decnet_tpu_torch.nn.layers import (ConvUnit, Conv3dUnit, pixel_shuffle,
                                        unfold3x3_replicate, unfold_nonoverlap)
from decnet_tpu_torch.ops.kernels import warp as warp_kernel


class CostRegNet(nn.Module):
    """3D cost aggregation at constant resolution: 2 convs, a 3-conv
    residual block, 3 convs ending in 1 channel.  (B,C,S,H,W) -> (B,S,H,W)."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        f = features
        for name in ("conv0_0", "conv0_1", "conv1_0", "conv1_1", "conv1_2",
                     "conv2_0", "conv2_1"):
            self.add_module(name, Conv3dUnit(f, f, dtype=dtype))
        self.conv2_2 = Conv3dUnit(f, 1, relu=False, dtype=dtype)

    def forward(self, vol: torch.Tensor) -> torch.Tensor:
        x0 = self.conv0_1(self.conv0_0(vol))
        x = self.conv1_2(self.conv1_1(self.conv1_0(x0)))
        x = x + x0
        x = self.conv2_2(self.conv2_1(self.conv2_0(x)))
        return x[:, 0]


class DynamicUpsampling(nn.Module):
    """Content-aware x`scale` disparity upsampling: scale^2 * 9 softmax
    weights per coarse pixel from (disp, unfolded fine features), applied to
    the 3x3 coarse neighbourhood, pixel-shuffled, values scaled by `scale`."""

    def __init__(self, fine_channels: int, scale: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.scale = scale
        n = scale * scale * 9
        self.w0 = ConvUnit(1 + fine_channels * scale * scale, n, 3, padding=1,
                           dtype=dtype)
        self.w1 = ConvUnit(n, n, 3, padding=1, dtype=dtype)
        self.w2 = ConvUnit(n, n, 3, padding=1, relu=False, dtype=dtype)

    def forward(self, disp: torch.Tensor,
                fine_fea: torch.Tensor) -> torch.Tensor:
        B, H, W = disp.shape
        r = self.scale
        feats = unfold_nonoverlap(fine_fea, r)               # (B,C*r^2,H,W)
        inp = torch.cat([disp[:, None].to(feats.dtype), feats], dim=1)
        w = self.w2(self.w1(self.w0(inp)))
        w = torch.softmax(w.float().reshape(B, r * r, 9, H, W), dim=2)
        content = unfold3x3_replicate(disp.float())          # (B,9,H,W)
        res = torch.einsum("brkhw,bkhw->brhw", w, content) * r
        return pixel_shuffle(res, r)[:, 0]


class SoftAttention(nn.Module):
    """Dense/sparse fusion mask head: sigmoid of a 3-conv stack, (B,H,W)."""

    def __init__(self, in_ch: int, base_channels: int = 8,
                 dtype=torch.float32):
        super().__init__()
        bc = base_channels
        self.c0 = ConvUnit(in_ch, bc, 3, padding=1, dtype=dtype)
        self.c1 = ConvUnit(bc, bc, 3, padding=1, dtype=dtype)
        self.c2 = ConvUnit(bc, 1, 3, padding=1, relu=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.c2(self.c1(self.c0(x))).float())[:, 0]


class Refinement(nn.Module):
    """Residual refinement: warp the right features by the current
    disparity, concat [left, warped, disp], a 7-conv head whose dilations
    grow with the stage.  Returns (disp + residual, residual)."""

    DILATIONS = {0: (1, 1, 1), 1: (1, 1, 1), 2: (2, 4, 6), 3: (3, 6, 9)}

    def __init__(self, features: int, stage_id: int = 1, dtype=torch.float32):
        super().__init__()
        f, h = features, features // 2
        d1, d2, d3 = self.DILATIONS[stage_id]
        self.c0 = ConvUnit(2 * f + 1, f, 3, dilation=d1, padding=d1,
                           dtype=dtype)
        self.c1 = ConvUnit(f, f, 3, padding=1, dtype=dtype)
        self.c2 = ConvUnit(f, f, 3, dilation=d2, padding=d2, dtype=dtype)
        self.c3 = ConvUnit(f, h, 3, padding=1, dtype=dtype)
        self.c4 = ConvUnit(h, h, 3, dilation=d3, padding=d3, dtype=dtype)
        self.c5 = ConvUnit(h, h, 3, padding=1, dtype=dtype)
        self.c6 = ConvUnit(h, 1, 3, padding=1, relu=False, bn=False,
                           dtype=dtype)

    def forward(self, left_fea: torch.Tensor, right_fea: torch.Tensor,
                disp: torch.Tensor, max_disp: int,
                warp: Callable = warp_kernel.warp_with_grad
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`warp` is the differentiable warp over the kernel's wrapper by
        default (its plain version on CPU tensors); pass a `warp_with_grad`
        with use_kernel=False to run the plain version on a card."""
        warped = warp(right_fea.contiguous(), disp.float().contiguous(),
                      max_disp).to(left_fea.dtype)
        x = torch.cat([left_fea, warped, disp[:, None].to(left_fea.dtype)],
                      dim=1)
        for i in range(7):
            x = getattr(self, f"c{i}")(x)
        residual = x.float()[:, 0]
        return disp + residual, residual
