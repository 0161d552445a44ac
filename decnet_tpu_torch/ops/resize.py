"""Torch-parity image resize (F.interpolate, align_corners=False) as two
matrix products, one per axis — the port of decnet_tpu/ops/resize.py.

The tap matrices are built in numpy exactly as the JAX package builds them
(bicubic with a=-0.75, edge taps clamped), so both packages apply the same
weights; F.interpolate is not used.

On row shards (`mesh.splits("tile")`) a resize along H applies the global
tap matrix's rows of this shard to the shard and the neighbour rows they
reach (`row_taps`, `mesh.halo`): no rank gathers the image."""
from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from decnet_tpu_torch.parallel import mesh


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


_ROW_TAPS: Dict[tuple, Tuple[np.ndarray, int, int]] = {}


def row_taps(key: tuple, make: Callable[[], np.ndarray]
             ) -> Tuple[np.ndarray, int, int]:
    """(taps, lo, hi) of this tile rank for the global (out, in) matrix
    that `make` builds (cached under `key`): taps (out/tile, lo + in/tile +
    hi) applies to the rank's rows with lo rows before and hi after, the
    largest reach of any shard (every rank exchanges the same halo)."""
    n, t = mesh.axis_size("tile"), mesh.axis_index("tile")
    k = key + (n, t)
    if k not in _ROW_TAPS:
        M = make()
        O, I = M.shape
        o, L = O // n, I // n
        lo = hi = 0
        for j in range(n):
            cols = np.nonzero(np.any(M[j * o:(j + 1) * o] != 0, axis=0))[0]
            if cols.size:
                lo = max(lo, j * L - int(cols[0]))
                hi = max(hi, int(cols[-1]) + 1 - (j + 1) * L)
        taps = np.zeros((o, lo + L + hi), np.float32)
        a, b = t * L - lo, (t + 1) * L + hi
        ca, cb = max(a, 0), min(b, I)
        taps[:, ca - a:cb - a] = M[t * o:(t + 1) * o, ca:cb]
        _ROW_TAPS[k] = (taps, lo, hi)
    return _ROW_TAPS[k]


def interpolate(img: torch.Tensor, out_h: int, out_w: int,
                mode: str) -> torch.Tensor:
    """Resize (B,C,H,W) to (out_h, out_w), torch semantics; on row shards
    H and out_h are this rank's rows of the image's."""
    H, W = img.shape[-2:]
    if H != out_h:
        if mesh.splits("tile"):
            n = mesh.axis_size("tile")
            taps, lo, hi = row_taps(
                ("resize", H * n, out_h * n, mode),
                lambda: _resize_matrix(H * n, out_h * n, mode))
            img = mesh.halo(img, 2, lo, hi)
        else:
            taps = _resize_matrix(H, out_h, mode)
        my = torch.from_numpy(taps).to(img.device, img.dtype)
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
