"""Sparse-matching moments: the CUDA kernel `csrc/spamat_moments.cu` and
its plain PyTorch version.

Port of decnet_tpu/ops/pallas/spamat.py::_moments_kernel (the TPU kernel)
and of its XLA twin decnet_tpu/ops/matching.py::matching_moments (:67-112),
whose loop over d `moments_plain` reproduces.  For each query with
ref_mask != 0 they compute, over the band d in [0, max_disp) of keys
tar[..., w - d] with tar_mask != 0 (and |d - center| <= window when
window > 0), the masked-softmax moments

    m = max(max_d s(d), 1e-6),  se = sum e,  sed = sum e*d,  sed2 = sum e*d^2

with e = exp(s(d) - m) and s(d) the feature dot product.  A query with no
candidate gets se = sed = sed2 = 0.  Queries with ref_mask == 0 may hold any
value: every consumer gates by ref_mask.

Features are NCHW (B,C,H,W), bf16 or f32 (scores accumulate in f32); masks
and center are (B,H,W) f32; the four outputs are (B,H,W) f32.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from decnet_tpu_torch.ops.kernels import build

EPS = 1e-6
_NEG = -3.0e38  # the reference's stand-in for -inf

_SIGNATURES = {"spamat_moments": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
               + [ctypes.c_void_p]}

Moments = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def moments_plain(ref: torch.Tensor, tar: torch.Tensor,
                  ref_mask: torch.Tensor, tar_mask: torch.Tensor,
                  max_disp: int, center: Optional[torch.Tensor] = None,
                  window: int = 0) -> Moments:
    """The moments as an online softmax over d = 0..max_disp-1, in f32."""
    W = ref.shape[-1]
    ref = ref.float()
    tarp = F.pad(tar.float(), (max_disp - 1, 0))
    okp = F.pad((tar_mask != 0).float(), (max_disp - 1, 0))
    m = torch.full(ref_mask.shape, _NEG, dtype=torch.float32,
                   device=ref.device)
    se = torch.zeros_like(m)
    sed = torch.zeros_like(m)
    sed2 = torch.zeros_like(m)
    for d in range(max_disp):
        lo = max_disp - 1 - d
        tar_d = tarp[..., lo:lo + W]
        ok = okp[..., lo:lo + W] > 0
        if window > 0:
            ok = ok & ((d - center.float()).abs() <= window)
        s = torch.where(ok, (ref * tar_d).sum(dim=1), _NEG)
        m_new = torch.maximum(m, s)
        scale = torch.exp(m - m_new)
        e = torch.where(ok, torch.exp(s - m_new), 0.0)
        se = se * scale + e
        sed = sed * scale + e * d
        sed2 = sed2 * scale + e * d * d
        m = m_new
    m_fin = torch.clamp(m, min=EPS)
    r = torch.exp(m - m_fin)             # rescale to the clamped max
    return m_fin, se * r, sed * r, sed2 * r


def _check(ref, tar, ref_mask, tar_mask, max_disp, center, window):
    if ref.dtype not in (torch.float32, torch.bfloat16) or tar.dtype != ref.dtype:
        raise TypeError(f"features must share dtype f32 or bf16, got "
                        f"{ref.dtype}/{tar.dtype}")
    if ref.dim() != 4 or tar.shape != ref.shape:
        raise ValueError(f"ref/tar must be (B,C,H,W) of one shape, got "
                         f"{tuple(ref.shape)}/{tuple(tar.shape)}")
    B, _, H, W = ref.shape
    maps = [ref_mask, tar_mask] + ([center] if window > 0 else [])
    for t in maps:
        if t is None or t.dtype != torch.float32 or t.shape != (B, H, W):
            raise ValueError(f"masks/center must be f32 (B,H,W)=({B},{H},{W})")
    for t in [ref, tar] + maps:
        if t.device != ref.device or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous on one device")
    if max_disp < 1 or window < 0:
        raise ValueError(f"bad max_disp {max_disp} / window {window}")


def moments(ref: torch.Tensor, tar: torch.Tensor, ref_mask: torch.Tensor,
            tar_mask: torch.Tensor, max_disp: int,
            center: Optional[torch.Tensor] = None,
            window: int = 0) -> Moments:
    """The moments: the CUDA kernel for CUDA tensors, `moments_plain` for
    CPU tensors.  Counts its kernel launches in `moments.launches`."""
    if ref.device.type == "cpu":
        return moments_plain(ref, tar, ref_mask, tar_mask, max_disp, center,
                             window)
    if ref.device.type != "cuda":
        raise ValueError(f"unsupported device {ref.device}")
    window = int(window) if center is not None else 0
    _check(ref, tar, ref_mask, tar_mask, max_disp, center, window)
    B, C, H, W = ref.shape
    lib = build.load("spamat_moments", _SIGNATURES)
    out = torch.empty((4, B, H, W), dtype=torch.float32, device=ref.device)
    with torch.cuda.device(ref.device):
        rc = lib.spamat_moments(
            ref.data_ptr(), tar.data_ptr(), ref_mask.data_ptr(),
            tar_mask.data_ptr(), center.data_ptr() if window > 0 else None,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            out[3].data_ptr(), B, C, H, W, int(max_disp), window,
            int(ref.dtype == torch.bfloat16),
            torch.cuda.current_stream(ref.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spamat_moments launch failed: cudaError_t {rc} "
                           f"(B,C,H,W={B},{C},{H},{W}, max_disp={max_disp})")
    moments.launches += 1
    return out[0], out[1], out[2], out[3]


moments.launches = 0
