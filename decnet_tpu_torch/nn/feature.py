"""Shared-weight feature pyramid — the port of decnet_tpu/nn/feature.py
(reference FeatExtNetChannelPlus) with 1 to 4 stages, faithful or with the
full-resolution level in space-to-depth form (`s2d_last`).  Below, the
four-stage pyramid; with fewer stages the encoder stops early and the
coarsest level it reaches is stage 0.

Encoder: conv0 (C, full res) -> conv1 (3C, 1/3) -> conv2 (9C, 1/9) ->
conv3 (27C, 1/27) with an ASPP context branch fused by 1x1 convs.  Decoder:
three deconv blocks (stride-3 transposed conv + skip concat + 2 convs).
Returns [stage0 (1/27, 27C), stage1 (1/9, 9C), stage2 (1/3, 3C),
stage3 (full, C)]: 216/72/24/8 channels for C = 8.

With `s2d_last` the image enters as `space_to_depth(x, 3)` (27 channels at
1/3), the full-resolution level runs at 1/3 with 9C channels (conv1_0 at
stride 1), and the last decoder block is a 1x1 conv of the 1/3 level
(`deconv1_s2d`, the stride-3 transposed conv in s2d space), a concat with
the skip and two convs (`deconv1_c0`, `deconv1_c1`): stage3 is then
(B, 9C, H/3, W/3), channel (i*3 + j)*C + c holding phase (i, j).  With
`s2d_mid` (s2d_stages 2) the 1/3-res level is also emitted in s2d form,
`space_to_depth(stage2, 3)`: (B, 27C, H/9, W/9), a pure reshape with no
parameters of its own; the decoder still reads it unpacked."""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from decnet_tpu_torch.nn.layers import ConvUnit, DeconvUnit, space_to_depth


class ASPP(nn.Module):
    """1x1 conv + 3x3 convs at the given dilation rates, concatenated."""

    def __init__(self, in_ch: int, features: int,
                 rates: Sequence[int] = (4, 8, 12), dtype=torch.float32):
        super().__init__()
        self.c0 = ConvUnit(in_ch, features, 1, padding=0, dtype=dtype)
        for i, r in enumerate(rates):
            self.add_module(f"c{i + 1}", ConvUnit(in_ch, features, 3,
                                                  dilation=r, padding=r,
                                                  dtype=dtype))
        self.n = len(rates) + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([getattr(self, f"c{i}")(x) for i in range(self.n)],
                         dim=1)


class DeconvBlock(nn.Module):
    """Stride-3 upsample of the coarse input, concat with the skip, 2 convs."""

    def __init__(self, in_ch: int, skip_ch: int, features: int,
                 dtype=torch.float32):
        super().__init__()
        self.deconv = DeconvUnit(in_ch, features, 3, 3, dtype=dtype)
        self.conv_0 = ConvUnit(features + skip_ch, features, 3, padding=1,
                               dtype=dtype)
        self.conv_1 = ConvUnit(features, features, 3, padding=1, dtype=dtype)

    def forward(self, x_skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([self.deconv(x), x_skip], dim=1)
        return self.conv_1(self.conv_0(y))


class FeatureExtractor(nn.Module):
    """`num_stage` levels, coarse to fine: the encoder goes as deep as the
    stages need (conv0 alone for 1 stage; conv0-conv1 for 2; conv0-conv2
    for 3; conv0-conv3 with the ASPP context for 4) and the decoder climbs
    back with one deconv block per level, as decnet_tpu/nn/feature.py
    does.  `s2d_last` (with more than one stage) and `s2d_mid` as in the
    module's docstring."""

    def __init__(self, base_channels: int = 8, down_scale: int = 3,
                 s2d_last: bool = False, s2d_mid: bool = False,
                 dtype=torch.float32, num_stage: int = 4):
        super().__init__()
        C, s, ns = base_channels, down_scale, num_stage
        c1, c2, c3 = C * s, C * s * s, C * s ** 3
        s2d_last = s2d_last and ns > 1
        self.scale, self.num_stage = s, ns
        self.s2d_last, self.s2d_mid = s2d_last, s2d_mid and ns > 1
        C0 = C * s * s if s2d_last else C
        # coarse -> fine, as emitted
        chans = [C * s ** (ns - 1 - i) for i in range(ns)]
        chans[-1] = C0
        if self.s2d_mid:
            chans[-2] *= s * s
        self.out_channels = chans

        def unit(name, cin, cout, k=3, stride=1, padding=1):
            self.add_module(name, ConvUnit(cin, cout, k, stride=stride,
                                           padding=padding, dtype=dtype))

        unit("conv0_0", 3 * s * s if s2d_last else 3, C0)
        unit("conv0_1", C0, C0)
        if ns == 1:
            return
        unit("conv1_0", C0, c1, stride=1 if s2d_last else s)
        unit("conv1_1", c1, c1)
        unit("conv1_2", c1, c1)
        if ns > 2:
            unit("conv2_0", c1, c2, stride=s)
            unit("conv2_1", c2, c2)
            unit("conv2_2", c2, c2)
            if ns > 3:
                unit("conv3_1", c2, c3, stride=s)
                unit("conv3_2a", c3, c3)
                unit("conv3_2b", c3, c3)
                self.aspp = ASPP(c3, c3, dtype=dtype)
                unit("ctx_fuse", 4 * c3, c3, k=1, padding=0)
                unit("fusion", 2 * c3, c3, k=1, padding=0)
                unit("trans2", c2, c2, k=1, padding=0)
                self.deconv3 = DeconvBlock(c3, c2, c2, dtype=dtype)
            unit("trans1", c1, c1, k=1, padding=0)
            self.deconv2 = DeconvBlock(c2, c1, c1, dtype=dtype)
        unit("trans0", C0, C0, k=1, padding=0)
        if s2d_last:
            unit("deconv1_s2d", c1, C0, k=1, padding=0)
            unit("deconv1_c0", 2 * C0, C0)
            unit("deconv1_c1", C0, C0)
        else:
            self.deconv1 = DeconvBlock(c1, C, C, dtype=dtype)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        ns = self.num_stage
        if self.s2d_last:
            x = space_to_depth(x, self.scale)
        conv0 = self.conv0_1(self.conv0_0(x))
        if ns == 1:
            return [conv0]
        conv1 = self.conv1_2(self.conv1_1(self.conv1_0(conv0)))
        levels = []
        res = conv1
        if ns > 2:
            res = conv2 = self.conv2_2(self.conv2_1(self.conv2_0(conv1)))
            if ns > 3:
                conv3_1 = self.conv3_1(conv2)
                conv3_2 = self.conv3_2b(self.conv3_2a(conv3_1))
                ctx = self.ctx_fuse(self.aspp(conv3_1))
                stage0 = self.fusion(torch.cat([conv3_2, ctx], dim=1))
                levels.append(stage0)
                res = self.deconv3(self.trans2(conv2), stage0)
            levels.append(res)
            res = self.deconv2(self.trans1(conv1), res)
        skip0 = self.trans0(conv0)
        if self.s2d_last:
            y = torch.cat([self.deconv1_s2d(res), skip0], dim=1)
            last = self.deconv1_c1(self.deconv1_c0(y))
        else:
            last = self.deconv1(skip0, res)
        levels.append(space_to_depth(res, self.scale) if self.s2d_mid
                      else res)
        return levels + [last]
