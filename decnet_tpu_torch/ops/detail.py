"""Detail masks on the device — the port of decnet_tpu/ops/detail.py:
the Gaussian-pyramid residual masks (:37-86, the reference's
`detailDetection`) and the Haar wavelet masks (:89-151, utils/Wavelet.py).

Per pyramid level: blur and downsample by `scale`, upsample back and blur,
sum |residual| over RGB, min-max normalise per image and threshold.  The JAX
docstring states this matches the host pipeline `data/masks.py::
detail_masks_np` that the JAX demo uses; here it runs on the card inside
`predict`."""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from decnet_tpu_torch.ops.resize import interpolate


def _gauss_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel parity (normalised sampled Gaussian)."""
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int,
                  sigma: float = 1.0) -> torch.Tensor:
    """Separable Gaussian blur of (B,C,H,W) with reflect-101 borders (cv2's
    default, F.pad's "reflect"); rows first, then columns, as in JAX."""
    k = [float(v) for v in _gauss_kernel1d(ksize, sigma)]
    pad = ksize // 2
    H, W = img.shape[-2:]
    x = F.pad(img, (0, 0, pad, pad), mode="reflect")
    x = sum(k[i] * x[:, :, i:i + H] for i in range(ksize))
    x = F.pad(x, (pad, pad, 0, 0), mode="reflect")
    return sum(k[i] * x[:, :, :, i:i + W] for i in range(ksize))


def detail_residuals(img: torch.Tensor, scale: int = 3,
                     levels: int = 3) -> List[torch.Tensor]:
    """Min-max normalised pyramid residuals, (B,h,w) f32 in [0,1] each,
    finest first.  `img` (B,3,H,W) in [0,1], H and W divisible by
    scale**levels."""
    data = img.float()
    norms = []
    for _ in range(levels):
        H, W = data.shape[-2:]
        down = interpolate(gaussian_blur(data, 3, 1.0), H // scale,
                           W // scale, "bilinear")
        up = gaussian_blur(interpolate(down, H, W, "bilinear"), 5, 1.0)
        r = (data - up).abs().sum(dim=1)
        lo = r.amin(dim=(1, 2), keepdim=True)
        hi = r.amax(dim=(1, 2), keepdim=True)
        norms.append((r - lo) / torch.clamp(hi - lo, min=1e-12))
        data = down
    return norms


def detail_masks(img: torch.Tensor, scale: int = 3, levels: int = 3,
                 thold: float = 0.3) -> List[torch.Tensor]:
    """Binary detail masks, coarsest first (`masks[stage - 1]` feeds fine
    stage `stage`), each (B,h,w) f32 in {0,1}."""
    return [(n >= thold).float()
            for n in detail_residuals(img, scale, levels)][::-1]


# Haar analysis filters of the detail bands, over a 2x2 cell (row, column)
_HAAR = (((0.5, 0.5), (-0.5, -0.5)),      # lh
         ((0.5, -0.5), (0.5, -0.5)),      # hl
         ((0.5, -0.5), (-0.5, 0.5)))      # hh


def _haar_bands(gray: torch.Tensor):
    """One Haar analysis step of (B,H,W): (the 2x2 mean, the max |band|
    over the three detail bands), each (B,ceil(H/2),ceil(W/2)); an odd
    side gets one edge-replicated row or column first."""
    H, W = gray.shape[-2:]
    if H % 2 or W % 2:
        gray = torch.nn.functional.pad(gray[:, None], (0, W % 2, 0, H % 2),
                                       mode="replicate")[:, 0]
        H, W = gray.shape[-2:]
    B = gray.shape[0]
    x = gray.reshape(B, H // 2, 2, W // 2, 2)
    e = None
    for f in _HAAR:
        k = torch.tensor(f, dtype=gray.dtype, device=gray.device)
        band = torch.einsum("bhiwj,ij->bhw", x, k).abs()
        e = band if e is None else torch.maximum(e, band)
    return x.mean(dim=(2, 4)), e


def _adaptive_wavelet_threshold(norm: torch.Tensor,
                                target: float) -> torch.Tensor:
    """Per image, the first t of 0.1, 0.2, ..., 1.0 for which the share of
    values <= t reaches `target` (utils/Wavelet.py:96-106): (B,)."""
    flat = norm.reshape(norm.shape[0], -1)
    ts = (torch.arange(1, 11, dtype=norm.dtype, device=norm.device)
          / torch.tensor(10.0, dtype=norm.dtype, device=norm.device))
    frac = (flat[:, None, :] <= ts[None, :, None]).float().mean(dim=-1)
    first = torch.argmax((frac >= target).int(), dim=1)
    return ts[first]


def wavelet_detail_masks(img: torch.Tensor, levels: int = 3,
                         target: float = 0.85) -> List[torch.Tensor]:
    """Wavelet detail masks of (B,C,H,W) images, coarsest first at
    H / 2^level: per level one Haar step on the running mean plane, the
    max |detail band| min-max normalised per image and cut at the adaptive
    threshold (>=)."""
    gray = img.mean(dim=1)
    masks = []
    for _ in range(levels):
        gray, e = _haar_bands(gray)
        lo = e.amin(dim=(1, 2), keepdim=True)
        hi = e.amax(dim=(1, 2), keepdim=True)
        norm = (e - lo) / torch.clamp(hi - lo, min=1e-12)
        th = _adaptive_wavelet_threshold(norm, target)
        masks.append((norm >= th[:, None, None]).float())
    return masks[::-1]
