"""Conv building blocks and layout helpers, NCHW/NCDHW — the port of
decnet_tpu/nn/layers.py:200-413 and :414-421.

Each unit casts its convolution weights to its compute dtype at every call,
as the JAX package does.  For serving they are stored in that dtype, so the
cast is a no-op; for training `train.step.create_train_state` stores them in
f32, so that the optimizer updates f32 values.  Batch norm keeps its parameters and
statistics in f32, folds them into a per-channel multiplier and offset in
f32 and casts those to the activation dtype, as `FoldedBatchNorm` does in
JAX.  With the `gn` norm (`norm_override("gn")` around the model's
construction, as `ModelConfig.norm` asks) every unit's batch norm is a
`GroupNorm` instead, as decnet_tpu/nn/layers.py::_make_norm makes it.
Submodule names (`conv`, `bn`, `gn`) are what `weights.py` maps the flax
names `Conv_0`/`ConvTranspose_0`, `BatchNorm_0` and `GroupNorm_0` onto."""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn as nn
import torch.nn.functional as F

# The norm of the units built inside `norm_override`: "bn" (the reference's
# batch norm) or "gn" (GroupNorm in every unit that would have batch norm).
_NORM = contextvars.ContextVar("decnet_torch_norm", default="bn")


@contextlib.contextmanager
def norm_override(norm: str):
    """Units built inside use `norm` ("bn" or "gn") for their batch norm."""
    if norm not in ("bn", "gn"):
        raise ValueError(f"unknown norm {norm!r}")
    tok = _NORM.set(norm)
    try:
        yield
    finally:
        _NORM.reset(tok)


def group_count(channels: int) -> int:
    """The largest divisor of `channels` not above channels // 8 (at
    least 1): groups of about 8 channels."""
    cap = max(1, channels // 8)
    return max(g for g in range(1, cap + 1) if channels % g == 0)


class GroupNorm(nn.Module):
    """flax's nn.GroupNorm(group_count(C), epsilon=1e-6) with f32
    parameters and a compute dtype: the statistics in f32 over each
    group's channels and every position (var = max(E[x^2] - E[x]^2, 0),
    flax's fast variance), then (x - mean) * (rsqrt(var + eps) * scale) +
    bias in f32, cast to x's dtype."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.groups = group_count(channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        G = self.groups
        xf = x.float()
        g = xf.reshape(B, G, -1)
        mean = g.mean(-1)
        var = torch.clamp((g * g).mean(-1) - mean * mean, min=0.0)
        shape = (B, C) + (1,) * (x.dim() - 2)
        mean = mean.repeat_interleave(C // G, dim=1).view(shape)
        inv = torch.rsqrt(var + self.eps).repeat_interleave(C // G, dim=1)
        mul = (inv * self.weight).view(shape)
        y = (xf - mean) * mul + self.bias.view((1, C) + (1,) * (x.dim() - 2))
        return y.to(x.dtype)


class _BatchStats(torch.autograd.Function):
    """(mean, biased variance) of x in f32 over every axis but the
    channels.  It saves x itself, in its own dtype, where autograd through
    `x.float().var()` would keep the f32 copy (twice a bf16 activation's
    bytes, for every batch-norm unit of a step); the backward computes
    g_mean / n + g_var * 2 (x - mean) / n in f32 from it and casts once,
    as the cast's own backward would."""

    @staticmethod
    def forward(ctx, x):
        xf = x.float()
        dims = [0] + list(range(2, x.dim()))
        mean = xf.mean(dims)
        var = xf.var(dims, unbiased=False)
        ctx.save_for_backward(x, mean)
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x, mean = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        g = torch.zeros((), device=x.device)
        if g_mean is not None:
            g = g + g_mean.view(shape) / n
        if g_var is not None:
            g = g + (2.0 / n) * g_var.view(shape) * (x.float()
                                                     - mean.view(shape))
        return g.expand(x.shape).to(x.dtype)


class FoldedBatchNorm(nn.Module):
    """Batch norm: x * mul + ofs, mul = scale / sqrt(var + eps),
    ofs = bias - mean * mul, folded in f32 and cast to x's dtype.

    In eval mode (mean, var) are the running statistics.  In train mode
    they are the batch statistics in f32 over every axis but the channels
    (the variance biased; `_BatchStats`), and the running statistics move to
    momentum * running + (1 - momentum) * batch, in place.  This is the
    flax convention of the JAX package; torch's own batch norm updates with
    the unbiased variance and the opposite momentum, so it is not used."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = _BatchStats.apply(x)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = self.weight * torch.rsqrt(var + self.eps)
        ofs = self.bias - mean * mul
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * mul.to(x.dtype).view(shape) + ofs.to(x.dtype).view(shape)


class _Unit(nn.Module):
    """conv -> optional norm -> optional ReLU, the conv in `dtype`; the
    norm is batch norm (`bn`), or group norm (`gn`) when built inside
    `norm_override("gn")`."""

    def __init__(self, conv: nn.Module, out_ch: int, relu: bool, bn: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.conv = conv
        gn = bn and _NORM.get() == "gn"
        self.bn = FoldedBatchNorm(out_ch) if bn and not gn else None
        self.gn = GroupNorm(out_ch) if gn else None
        self.relu = relu
        self.dtype = dtype

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        conv, dt = self.conv, self.dtype
        w = conv.weight.to(dt)
        b = None if conv.bias is None else conv.bias.to(dt)
        if isinstance(conv, nn.ConvTranspose2d):
            return F.conv_transpose2d(x.to(dt), w, b, conv.stride,
                                      conv.padding, conv.output_padding,
                                      conv.groups, conv.dilation)
        return conv._conv_forward(x.to(dt), w, b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.gn is not None:
            x = self.gn(x)
        return F.relu(x) if self.relu else x


class ConvUnit(_Unit):
    """Conv2d + BatchNorm + ReLU (reference Conv2dUnit)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, padding: int = 0,
                 relu: bool = True, bn: bool = True, dtype=torch.float32):
        super().__init__(nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                                   padding=padding, dilation=dilation,
                                   bias=not bn, dtype=dtype),
                         out_ch, relu, bn, dtype)


class DeconvUnit(_Unit):
    """ConvTranspose2d(k=3, s=3, p=0) + BatchNorm + ReLU: exactly 3x the
    input size (reference Deconv2dUnit)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 3, relu: bool = True, bn: bool = True,
                 dtype=torch.float32):
        super().__init__(nn.ConvTranspose2d(in_ch, out_ch, kernel_size,
                                            stride=stride, bias=not bn,
                                            dtype=dtype),
                         out_ch, relu, bn, dtype)


class Conv3dUnit(_Unit):
    """Conv3d + BatchNorm + ReLU over (B,C,S,H,W) volumes."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, relu: bool = True,
                 bn: bool = True, dtype=torch.float32):
        super().__init__(nn.Conv3d(in_ch, out_ch, kernel_size, stride=stride,
                                   padding=padding, bias=not bn, dtype=dtype),
                         out_ch, relu, bn, dtype)


def unfold_nonoverlap(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B,C,H,W) -> (B,C*k*k,H/k,W/k), channel c*k*k + ki*k + kj (torch's
    F.unfold(kernel=k, stride=k) order)."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // k, k, W // k, k)
    x = x.permute(0, 1, 3, 5, 2, 4)             # B, C, ki, kj, H/k, W/k
    return x.reshape(B, C * k * k, H // k, W // k)


def unfold3x3_replicate(x: torch.Tensor) -> torch.Tensor:
    """3x3 neighbourhoods of (B,H,W) with edge replication -> (B,9,H,W),
    channel ki*3 + kj (the reference's F.unfold(ReplicationPad2d(1)(d)))."""
    H, W = x.shape[-2:]
    xp = F.pad(x[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    return torch.stack([xp[:, i:i + H, j:j + W]
                        for i in range(3) for j in range(3)], dim=1)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B,r*r,H,W) -> (B,1,H*r,W*r): channel i*r + j lands at offset (i, j)
    (torch F.pixel_shuffle with one output channel)."""
    B, C, H, W = x.shape
    if C != r * r:
        raise ValueError(f"pixel_shuffle needs {r * r} channels, got {C}")
    x = x.reshape(B, r, r, H, W).permute(0, 3, 1, 4, 2)   # B, H, i, W, j
    return x.reshape(B, 1, H * r, W * r)


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B,C,H,W) -> (B,r*r*C,H/r,W/r), channel (i*r + j)*C + c: the JAX
    package's phase-major order.  torch's F.pixel_unshuffle orders the
    channels c*r*r + i*r + j instead; the two agree only for C = 1, and the
    s2d convolutions' weights are stored for the phase-major order."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // r, r, W // r, r)
    x = x.permute(0, 3, 5, 1, 2, 4)             # B, i, j, C, H/r, W/r
    return x.reshape(B, r * r * C, H // r, W // r)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of `space_to_depth`: (B,r*r*C,h,w) -> (B,C,h*r,w*r)."""
    B, RC, h, w = x.shape
    C = RC // (r * r)
    x = x.reshape(B, r, r, C, h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)             # B, C, h, i, w, j
    return x.reshape(B, C, h * r, w * r)


def plane_to_s2d(m: torch.Tensor, r: int) -> torch.Tensor:
    """Planar map (B,H,W) -> s2d plane (B,r*r,H/r,W/r), channel i*r + j."""
    return space_to_depth(m[:, None], r)


def s2d_to_plane(p: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of `plane_to_s2d`: (B,r*r,h,w) -> (B,h*r,w*r)."""
    return depth_to_space(p, r)[:, 0]
