"""Per-stage heads of DecNet — the port of decnet_tpu/nn/heads.py:
cost regularisation, dynamic upsampling, soft attention, refinement and
the learned detail heads, with the space-to-depth twins of the last three
(`...S2D`), which run a full-resolution stage at 1/r resolution on s2d
planes: (B,r*r,h,w), channel i*r + j holding phase (i, j)."""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from decnet_tpu_torch.nn.layers import (ConvUnit, Conv3dUnit, DeconvUnit,
                                        pixel_shuffle, space_to_depth,
                                        unfold3x3_replicate, unfold_nonoverlap)
from decnet_tpu_torch.ops.kernels import warp as warp_kernel


class CostRegNet(nn.Module):
    """3D cost aggregation at constant resolution: 2 convs, a 3-conv
    residual block, 3 convs ending in 1 channel.  (B,C,S,H,W) -> (B,S,H,W).
    The `cat` cost's volume has 2C channels, which a 1x1x1 convolution
    without bias or norm (`conv_pre`) brings to C first."""

    def __init__(self, features: int, cost_func: str = "cor",
                 dtype=torch.float32):
        super().__init__()
        f = features
        self.dtype = dtype
        self.conv_pre = (nn.Conv3d(2 * f, f, 1, bias=False, dtype=dtype)
                         if cost_func == "cat" else None)
        for name in ("conv0_0", "conv0_1", "conv1_0", "conv1_1", "conv1_2",
                     "conv2_0", "conv2_1"):
            self.add_module(name, Conv3dUnit(f, f, dtype=dtype))
        self.conv2_2 = Conv3dUnit(f, 1, relu=False, dtype=dtype)

    def forward(self, vol: torch.Tensor) -> torch.Tensor:
        if self.conv_pre is not None:
            vol = F.conv3d(vol.to(self.dtype),
                           self.conv_pre.weight.to(self.dtype))
        x0 = self.conv0_1(self.conv0_0(vol))
        x = self.conv1_2(self.conv1_1(self.conv1_0(x0)))
        x = x + x0
        x = self.conv2_2(self.conv2_1(self.conv2_0(x)))
        return x[:, 0]


class DynamicUpsampling(nn.Module):
    """Content-aware x`scale` disparity upsampling: scale^2 * 9 softmax
    weights per coarse pixel from (disp, unfolded fine features), applied to
    the 3x3 coarse neighbourhood, pixel-shuffled, values scaled by `scale`.

    `pre_unfolded`: the fine features are already at the coarse resolution
    (s2d form, `fine_channels` of them), so they are not unfolded.
    `out_s2d`: return the (B,r*r,H,W) s2d plane instead of the shuffled
    (B,H*r,W*r) map (the weights' channel i*r + j is the plane's)."""

    def __init__(self, fine_channels: int, scale: int = 3,
                 pre_unfolded: bool = False, out_s2d: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.scale = scale
        self.pre_unfolded, self.out_s2d = pre_unfolded, out_s2d
        n = scale * scale * 9
        feats = fine_channels if pre_unfolded else fine_channels * scale ** 2
        self.w0 = ConvUnit(1 + feats, n, 3, padding=1, dtype=dtype)
        self.w1 = ConvUnit(n, n, 3, padding=1, dtype=dtype)
        self.w2 = ConvUnit(n, n, 3, padding=1, relu=False, dtype=dtype)

    def forward(self, disp: torch.Tensor,
                fine_fea: torch.Tensor) -> torch.Tensor:
        B, H, W = disp.shape
        r = self.scale
        feats = (fine_fea if self.pre_unfolded
                 else unfold_nonoverlap(fine_fea, r))          # (B,C*r^2,H,W)
        inp = torch.cat([disp[:, None].to(feats.dtype), feats], dim=1)
        w = self.w2(self.w1(self.w0(inp)))
        w = torch.softmax(w.float().reshape(B, r * r, 9, H, W), dim=2)
        content = unfold3x3_replicate(disp.float())          # (B,9,H,W)
        res = torch.einsum("brkhw,bkhw->brhw", w, content) * r
        if self.out_s2d:
            return res
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


class SoftAttentionS2D(nn.Module):
    """SoftAttention in s2d form: s2d features and four s2d planes (dense,
    sparse, mask, -var) in, the (B,r*r,h,w) sigmoid mask out."""

    def __init__(self, in_ch: int, scale: int = 3, hidden: int = 72,
                 dtype=torch.float32):
        super().__init__()
        self.c0 = ConvUnit(in_ch, hidden, 3, padding=1, dtype=dtype)
        self.c1 = ConvUnit(hidden, hidden, 3, padding=1, dtype=dtype)
        self.c2 = ConvUnit(hidden, scale * scale, 3, padding=1, relu=False,
                           dtype=dtype)
        self.dtype = dtype

    def forward(self, fea_s2d: torch.Tensor,
                planes_s2d: Sequence[torch.Tensor]) -> torch.Tensor:
        x = torch.cat([fea_s2d] + [p.to(self.dtype) for p in planes_s2d],
                      dim=1)
        return torch.sigmoid(self.c2(self.c1(self.c0(x))).float())


class RefinementS2D(nn.Module):
    """Refinement in s2d form: the full-resolution right features are
    warped by the full-resolution disparity and s2d-packed, concatenated
    with the s2d left features and disparity plane, and a 7-conv head with
    per-conv `kernels` and `dilations` (padding d*(k-1)//2) runs at 1/r.
    The default is the packed twin of stage 3's dilations 3/6/9
    (`models/repack.py::packed_geometry`); stage 2's 2/4/6 give kernels
    (3,3,5,3,3,3,3) and dilations (1,1,1,1,2,1,1), d=4 a 5-tap
    phase-mixing conv.  Returns (disp_s2d + residual, residual), both s2d
    planes."""

    def __init__(self, in_ch: int, scale: int = 3, hidden: int = 72,
                 kernels: Sequence[int] = (3,) * 7,
                 dilations: Sequence[int] = (1, 1, 2, 1, 3, 1, 1),
                 dtype=torch.float32):
        super().__init__()
        self.scale = scale
        h = hidden
        feats = (h, h, h, h // 2, h // 2, h // 2, scale * scale)
        cin = in_ch
        for i, (f, k, d) in enumerate(zip(feats, kernels, dilations)):
            self.add_module(f"c{i}", ConvUnit(
                cin, f, k, dilation=d, padding=d * (k - 1) // 2,
                relu=i < 6, bn=i < 6, dtype=dtype))
            cin = f

    def forward(self, left_s2d: torch.Tensor, right_fea: torch.Tensor,
                disp_s2d: torch.Tensor, disp_full: torch.Tensor,
                max_disp: int,
                warp: Callable = warp_kernel.warp_with_grad
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """right_fea (B,C,H,W) full-resolution; disp_s2d (B,r*r,h,w) and
        disp_full (B,H,W) are one disparity in both layouts."""
        warped = warp(right_fea.contiguous(), disp_full.float().contiguous(),
                      max_disp)
        warped = space_to_depth(warped, self.scale).to(left_s2d.dtype)
        x = torch.cat([left_s2d, warped, disp_s2d.to(left_s2d.dtype)], dim=1)
        for i in range(7):
            x = getattr(self, f"c{i}")(x)
        residual = x.float()
        return disp_s2d + residual, residual


class DetailHead(nn.Module):
    """Learned lost-detail logits (reference GenerateSparseMask): the
    coarser features through a stride-3 transposed conv, the finer through
    a conv, each to 3 channels; their squared difference through a 2-conv
    head.  (B,H,W) f32 logits."""

    def __init__(self, pre_channels: int, cur_channels: int,
                 dtype=torch.float32):
        super().__init__()
        self.deconv0 = DeconvUnit(pre_channels, 8, 3, 3, bn=False,
                                  dtype=dtype)
        self.deconv1 = ConvUnit(8, 3, 3, padding=1, relu=False, dtype=dtype)
        self.sub0 = ConvUnit(cur_channels, 8, 3, padding=1, bn=False,
                             dtype=dtype)
        self.sub1 = ConvUnit(8, 3, 3, padding=1, relu=False, dtype=dtype)
        self.head0 = ConvUnit(3, 3, 3, padding=1, relu=False, dtype=dtype)
        self.head1 = ConvUnit(3, 1, 1, padding=0, relu=False, dtype=dtype)

    def forward(self, cur_fea: torch.Tensor,
                pre_fea: torch.Tensor) -> torch.Tensor:
        p = self.deconv1(self.deconv0(pre_fea))
        c = self.sub1(self.sub0(cur_fea))
        return self.head1(self.head0((c - p) ** 2)).float()[:, 0]


class DetailHeadS2D(nn.Module):
    """DetailHead in s2d form: the coarser features (already at 1/r) through
    a 1x1 conv, the s2d features through a conv, each to 3*r*r channels;
    (B,r*r,h,w) f32 logits, an s2d plane."""

    def __init__(self, pre_channels: int, cur_channels: int, scale: int = 3,
                 dtype=torch.float32):
        super().__init__()
        rr = scale * scale
        self.deconv0 = ConvUnit(pre_channels, 8 * rr, 1, padding=0, bn=False,
                                dtype=dtype)
        self.deconv1 = ConvUnit(8 * rr, 3 * rr, 3, padding=1, relu=False,
                                dtype=dtype)
        self.sub0 = ConvUnit(cur_channels, 8 * rr, 3, padding=1, bn=False,
                             dtype=dtype)
        self.sub1 = ConvUnit(8 * rr, 3 * rr, 3, padding=1, relu=False,
                             dtype=dtype)
        self.head0 = ConvUnit(3 * rr, 3 * rr, 3, padding=1, relu=False,
                              dtype=dtype)
        self.head1 = ConvUnit(3 * rr, rr, 1, padding=0, relu=False,
                              dtype=dtype)

    def forward(self, cur_s2d: torch.Tensor,
                pre_fea: torch.Tensor) -> torch.Tensor:
        p = self.deconv1(self.deconv0(pre_fea))
        c = self.sub1(self.sub0(cur_s2d))
        return self.head1(self.head0((c - p) ** 2)).float()
