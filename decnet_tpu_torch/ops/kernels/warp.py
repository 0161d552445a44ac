"""Disparity warp: the CUDA kernel `csrc/warp.cu` and its plain PyTorch
version.

Port of decnet_tpu/ops/pallas/warp.py::warp_by_disparity_fast — the TPU
kernel `_hwarp_kernel` and the XLA vertical pass `_vert_interp` before it —
fused into one bilinear sample per output element.  Like the TPU kernel it
clips disparities to [-NEG_MARGIN, max_disp]; inside that range it equals
the reference warp `ops/warp.py::warp_by_disparity` (torch grid_sample
semantics: x = (w - d) * W/(W-1) - 0.5, y = h * H/(H-1) - 0.5, zero
padding).

Features are NCHW (B,C,H,W), bf16 or f32; disp is (B,H,W) f32; the result
has the features' dtype and is computed in f32.  `warp_plan` is the
kernel's launch geometry: the channels a block owns, its threads and its
shared memory, checked on the CPU by tests/test_torch_plans.py.

`warp_with_grad` makes the warp differentiable: its backward is the
vector-Jacobian product of the unclipped reference warp with respect to
image and disparity, as decnet_tpu/ops/pallas/warp.py::_fast_bwd (:188-194)
does.  The JAX package has no kernel for that backward, so neither does the
port.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from decnet_tpu_torch.ops.kernels import build
from decnet_tpu_torch.ops.kernels.staging import (GRAN_BYTES, MAP_GE,
                                                  MAX_THREADS, MIN_THREADS,
                                                  SMEM_BUDGET, SMEM_MAX,
                                                  TARGET_BLOCKS, align16,
                                                  aligned, row_stride)
from decnet_tpu_torch.ops.warp import warp_by_disparity

NEG_MARGIN = 16  # how far negative disparities are honoured

# feat, disp, out, B, C, H, W, max_disp, neg_margin, is_bf16, then the
# plan's cg, threads, smem, and the stream
_SIGNATURES = {"warp_disparity": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
               + [ctypes.c_void_p]}


@dataclasses.dataclass(frozen=True)
class WarpPlan:
    """The warp's launch: a block per (b, h) output row and group of `cg`
    channels (`groups` of them), `threads` threads, `smem` bytes of
    dynamic shared memory (`_warp_smem`: the source rows y0 and y0 + 1 of
    its channels and the disparity row)."""
    cg: int
    groups: int
    threads: int
    smem: int


def _warp_smem(cg: int, H: int, W: int, esize: int) -> int:
    """Shared bytes of a block: the source rows y0 and y0 + 1 of cg
    channels (staged rows of a (B,C,H,W) tensor) and the disparity row."""
    stride = row_stride(W, GRAN_BYTES // esize, H * W)
    return (2 * align16(esize * cg * stride)
            + align16(4 * row_stride(W, MAP_GE, 0)))


def warp_plan(B: int, C: int, H: int, W: int, esize: int) -> WarpPlan:
    """All C channels a block unless B*H rows leave fewer than
    TARGET_BLOCKS blocks (then C is split into groups until they do, or
    one channel a block) or the rows overflow SMEM_BUDGET."""
    groups = max(1, min(C, -(-TARGET_BLOCKS // (B * H))))
    while True:
        cg = -(-C // groups)
        smem = _warp_smem(cg, H, W, esize)
        if smem <= SMEM_BUDGET or cg == 1:
            break
        groups += 1
    if smem > SMEM_MAX:
        raise ValueError(f"no warp plan fits in {SMEM_MAX} bytes of shared "
                         f"memory (W={W}): {smem} for one channel")
    threads = min(MAX_THREADS, max(MIN_THREADS, -(-W // 32) * 32))
    return WarpPlan(cg, -(-C // cg), threads, smem)


def _fma_position(a: torch.Tensor, n: int) -> torch.Tensor:
    """a * n/(n-1) - 0.5 rounded once to f32, as a fused multiply-add gives
    (the kernel's __fmaf_rn and the JAX package's compiled warp): the f32
    product is exact in f64, and so is the subtraction at these sizes."""
    s = float(np.float32(n / (n - 1.0)))
    return (a.double() * s - 0.5).float()


def warp_plain(feat: torch.Tensor, disp: torch.Tensor,
               max_disp: int) -> torch.Tensor:
    """The vertical row pair, then the horizontal tent weights, in f32."""
    B, C, H, W = feat.shape
    f = feat.float()
    yy = _fma_position(torch.arange(H, dtype=torch.float32,
                                    device=feat.device), H)
    y0 = torch.floor(yy)
    wy1 = (yy - y0).view(1, 1, H, 1)
    wy0 = 1.0 - wy1

    def rows(idx):
        ok = ((idx >= 0) & (idx < H)).float().view(1, 1, H, 1)
        return f[:, :, idx.clamp(0, H - 1)] * ok

    y0 = y0.long()
    vert = rows(y0) * wy0 + rows(y0 + 1) * wy1
    d = disp.float().clamp(-float(NEG_MARGIN), float(max_disp))
    cols = torch.arange(W, dtype=torch.float32, device=feat.device)
    x = _fma_position(cols - d, W)                        # (B,H,W)
    x0 = torch.floor(x)
    wx0 = torch.clamp(1.0 - (x0 - x).abs(), min=0.0)
    wx1 = torch.clamp(1.0 - (x0 + 1.0 - x).abs(), min=0.0)

    def cols_at(idx):
        ok = ((idx >= 0) & (idx < W)).float()[:, None]
        g = idx.clamp(0, W - 1)[:, None].expand(B, C, H, W)
        return torch.gather(vert, 3, g) * ok

    xi = x0.long()
    out = wx0[:, None] * cols_at(xi) + wx1[:, None] * cols_at(xi + 1)
    return out.to(feat.dtype)


def _check(feat, disp, max_disp):
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features must be f32 or bf16, got {feat.dtype}")
    if feat.dim() != 4 or feat.shape[2] < 2 or feat.shape[3] < 2:
        raise ValueError(f"features must be (B,C,H,W) with H,W >= 2, got "
                         f"{tuple(feat.shape)}")
    B, C, H, W = feat.shape
    if disp.dtype != torch.float32 or disp.shape != (B, H, W):
        raise ValueError(f"disp must be f32 (B,H,W)=({B},{H},{W}), got "
                         f"{disp.dtype} {tuple(disp.shape)}")
    for t in (feat, disp):
        if t.device != feat.device or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous on one device")
    if feat.numel() >= 2 ** 31 or max_disp < 1:
        raise ValueError(f"unsupported size {feat.numel()} / max_disp "
                         f"{max_disp}")


def warp(feat: torch.Tensor, disp: torch.Tensor,
         max_disp: int) -> torch.Tensor:
    """The warp: the CUDA kernel for CUDA tensors, `warp_plain` for CPU
    tensors.  Counts its kernel launches in `warp.launches`."""
    if feat.device.type == "cpu":
        return warp_plain(feat, disp, max_disp)
    if feat.device.type != "cuda":
        raise ValueError(f"unsupported device {feat.device}")
    _check(feat, disp, max_disp)
    B, C, H, W = feat.shape
    feat, disp = aligned(feat), aligned(disp)
    plan = warp_plan(B, C, H, W, feat.element_size())
    lib = build.load("warp", _SIGNATURES)
    out = torch.empty_like(feat)
    with torch.cuda.device(feat.device):
        rc = lib.warp_disparity(
            feat.data_ptr(), disp.data_ptr(), out.data_ptr(), B, C, H, W,
            int(max_disp), NEG_MARGIN, int(feat.dtype == torch.bfloat16),
            plan.cg, plan.threads, plan.smem,
            torch.cuda.current_stream(feat.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"warp launch failed: cudaError_t {rc} "
                           f"(B,C,H,W={B},{C},{H},{W})")
    warp.launches += 1
    return out


warp.launches = 0


class _Warp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, disp, max_disp, use_kernel):
        ctx.save_for_backward(feat, disp)
        fn = warp if use_kernel else warp_plain
        return fn(feat, disp, max_disp)

    @staticmethod
    def backward(ctx, g):
        feat, disp = ctx.saved_tensors
        with torch.enable_grad():
            f = feat.detach().requires_grad_(ctx.needs_input_grad[0])
            d = disp.detach().requires_grad_(ctx.needs_input_grad[1])
            ref = warp_by_disparity(f, d)
            inputs = [t for t in (f, d) if t.requires_grad]
            grads = iter(torch.autograd.grad(ref, inputs, g.to(ref.dtype)))
        return (next(grads) if f.requires_grad else None,
                next(grads) if d.requires_grad else None, None, None)


def warp_with_grad(feat: torch.Tensor, disp: torch.Tensor, max_disp: int,
                   use_kernel: bool = True) -> torch.Tensor:
    """The warp, differentiable with respect to `feat` and `disp`:
    forward by `warp` (the kernel on a card, its plain version on CPU
    tensors) or, with use_kernel=False, by `warp_plain` on any device;
    backward through the unclipped reference warp."""
    return _Warp.apply(feat, disp, int(max_disp), bool(use_kernel))
