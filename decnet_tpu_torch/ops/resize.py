"""Torch-parity image resize (F.interpolate, align_corners=False) as two
matrix products, one per axis — the port of decnet_tpu/ops/resize.py.

The tap matrices are built in numpy exactly as the JAX package builds them
(bicubic with a=-0.75, edge taps clamped), so both packages apply the same
weights; F.interpolate is not used."""
from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    x = np.abs(x)
    return np.where(
        x <= 1, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
        np.where(x < 2, a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a, 0.0))


@functools.lru_cache(maxsize=256)
def _resize_matrix(in_size: int, out_size: int, mode: str) -> np.ndarray:
    """(out_size, in_size) interpolation matrix, torch align_corners=False."""
    scale = in_size / out_size
    mat = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(src))
        if mode == "bilinear":
            taps = [x0, x0 + 1]
            wgts = [1 - (src - x0), src - x0]
        elif mode == "bicubic":
            taps = [x0 - 1, x0, x0 + 1, x0 + 2]
            wgts = _cubic(src - np.array(taps, np.float64))
        else:
            raise ValueError(f"unknown resize mode {mode}")
        for k, g in zip(taps, wgts):
            mat[i, min(max(k, 0), in_size - 1)] += g
    return mat


def interpolate(img: torch.Tensor, out_h: int, out_w: int,
                mode: str) -> torch.Tensor:
    """Resize (B,C,H,W) to (out_h, out_w), torch semantics."""
    H, W = img.shape[-2:]
    if H != out_h:
        my = torch.from_numpy(_resize_matrix(H, out_h, mode)).to(
            img.device, img.dtype)
        img = torch.einsum("oh,bchw->bcow", my, img)
    if W != out_w:
        mx = torch.from_numpy(_resize_matrix(W, out_w, mode)).to(
            img.device, img.dtype)
        img = torch.einsum("ow,bchw->bcho", mx, img)
    return img


def downsample_gt(gt: torch.Tensor, down_size: int, mode: str) -> torch.Tensor:
    """Ground-truth pyramid level: values divided by `down_size`, then
    resized by it (decnet_tpu/ops/resize.py:64-86).  `gt` (B,H,W); mode
    bilinear or bicubic (tap matrices), max or min (over each
    down_size x down_size cell; min ignores gt <= 0)."""
    B, H, W = gt.shape
    h, w = H // down_size, W // down_size
    if mode in ("bilinear", "bicubic"):
        return interpolate((gt / down_size)[:, None], h, w, mode)[:, 0]
    if mode == "max":
        x = (gt / down_size).reshape(B, h, down_size, w, down_size)
        return x.amax(dim=(2, 4))
    if mode == "min":
        tmp = torch.where(gt > 0, gt, 1e6)
        x = (tmp / down_size).reshape(B, h, down_size, w, down_size)
        return x.amin(dim=(2, 4))
    raise ValueError(f"unknown down_func_name {mode}")


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k x k average pool of (B,C,H,W)."""
    B, C, H, W = x.shape
    return x.reshape(B, C, H // k, k, W // k, k).mean(dim=(3, 5))
