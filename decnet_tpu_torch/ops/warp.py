"""Disparity warping with torch-`grid_sample` parity — the port of
decnet_tpu/ops/warp.py:17-131.

`warp_by_disparity` is the unclipped reference warp (the JAX model's warp
off the TPU); `warp_volume_by_disparity` applies it per hypothesis of a
(B,S,H,W) set, and `grid_sample_normalized` samples at a grid in [-1, 1]
as torch's grid_sample(align_corners=False, padding_mode="zeros") does.  The model's Refinement warp goes through
`ops/kernels/warp.py`, which clips disparities like the TPU kernel does.
`warp_volume_uniform` builds the stage-0 volume for d = 0..max_disp-1 as two
matrix products with constant tap matrices."""
from __future__ import annotations

import functools

import numpy as np
import torch


def grid_sample_bilinear(img: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample `img` (B,C,H,W) at unnormalised pixel coordinates
    x, y (B,...) with zero padding; returns (B,C,*x.shape[1:]) in f32."""
    B, C, H, W = img.shape
    flat = img.reshape(B, C, H * W).float()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1

    def tap(xi, yi, wgt):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = (yi.clamp(0, H - 1).long() * W
               + xi.clamp(0, W - 1).long()).reshape(B, 1, -1)
        vals = torch.gather(flat, 2, idx.expand(B, C, idx.shape[-1]))
        return vals.reshape((B, C) + x.shape[1:]) * (wgt * inb)[:, None]

    return (tap(x0, y0, wx0 * wy0) + tap(x0 + 1, y0, wx1 * wy0)
            + tap(x0, y0 + 1, wx0 * wy1) + tap(x0 + 1, y0 + 1, wx1 * wy1))


def grid_sample_normalized(img: torch.Tensor,
                           grid: torch.Tensor) -> torch.Tensor:
    """Sample `img` (B,C,H,W) at `grid` (B,...,2) of normalised (x, y) in
    [-1, 1], unnormalised as ((g + 1) * size - 1) / 2
    (align_corners=False); returns (B,C,...) in f32."""
    H, W = img.shape[-2:]
    grid = grid.float()
    x = ((grid[..., 0] + 1.0) * W - 1.0) / 2.0
    y = ((grid[..., 1] + 1.0) * H - 1.0) / 2.0
    return grid_sample_bilinear(img, x, y)


def warp_by_disparity(img: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Sample right-view `img` (B,C,H,W) at ``x - disp`` (disp (B,H,W)):
    position ``(x - d) * W/(W-1) - 0.5``, rows ``y * H/(H-1) - 0.5``, as the
    reference's (W-1)/2 grid normalisation followed by align_corners=False
    grid_sample gives."""
    B, C, H, W = img.shape
    disp = disp.float()
    xs = torch.arange(W, dtype=torch.float32, device=disp.device)
    ys = torch.arange(H, dtype=torch.float32, device=disp.device)
    gx = (xs[None, None, :] - disp) / ((W - 1.0) / 2.0) - 1.0
    x = ((gx + 1.0) * W - 1.0) / 2.0
    y = ys[None, :, None].expand(disp.shape)
    yy = y * (H / (H - 1.0)) - 0.5
    return grid_sample_bilinear(img, x, yy)


def warp_volume_by_disparity(img: torch.Tensor,
                             disp_samples: torch.Tensor) -> torch.Tensor:
    """The right features warped by each hypothesis of `disp_samples`
    (B,S,H,W): (B,C,S,H,W) in f32 (reference submodule.py:479-510)."""
    return torch.stack([warp_by_disparity(img, disp_samples[:, s])
                        for s in range(disp_samples.shape[1])], dim=2)


def _affine_tap_matrix(n_out: int, n_in: int, pos) -> np.ndarray:
    """(n_out, n_in) bilinear sampling matrix: row i holds the two taps for
    sampling a length-n_in signal at pos[i], zeros outside."""
    pos = np.asarray(pos, np.float32)
    x0 = np.floor(pos)
    w1 = pos - x0
    M = np.zeros((n_out, n_in), np.float32)
    for tap, wgt in ((x0, 1.0 - w1), (x0 + 1.0, w1)):
        ti = tap.astype(np.int64)
        ok = (ti >= 0) & (ti < n_in)
        M[np.arange(n_out)[ok], ti[ok]] += wgt[ok]
    return M


@functools.lru_cache(maxsize=32)
def _uniform_tap_matrices(H: int, W: int, max_disp: int):
    """(Ry (H,H), Mx (S,W,W)) for the uniform hypotheses d = 0..S-1."""
    f = np.float32
    yy = np.arange(H, dtype=f) * f(H / (H - 1.0)) - f(0.5)
    Ry = _affine_tap_matrix(H, H, yy)
    xs = np.arange(W, dtype=f)
    half = f((W - 1.0) / 2.0)
    cols = []
    for d in range(max_disp):
        gx = (xs - f(d)) / half - f(1.0)
        xp = ((gx + f(1.0)) * f(W) - f(1.0)) / f(2.0)
        cols.append(_affine_tap_matrix(W, W, xp))
    return Ry, np.stack(cols)


def warp_volume_uniform(img: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Warped right-feature volume (B,C,S,H,W) for d = 0..max_disp-1 as
    ``Ry @ img @ Mx[d]^T``, accumulated in f32 and returned in img's dtype."""
    B, C, H, W = img.shape
    Ry, Mx = _uniform_tap_matrices(H, W, max_disp)
    Ry = torch.from_numpy(Ry).to(img.device)
    Mx = torch.from_numpy(Mx).to(img.device)
    tmp = torch.einsum("ih,bchw->bciw", Ry, img.float())
    out = torch.einsum("sxw,bchw->bcshx", Mx, tmp)
    return out.to(img.dtype)
