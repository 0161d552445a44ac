"""Host detail masks — the port of decnet_tpu/data/masks.py: the demo's
and the datasets' Gaussian-residual masks through the native library, the
anisotropic pre-filter, and the wavelet masks in numpy.

The Gaussian-pyramid residual masks come from
`native/decnet_native.cc::decnet_detail_masks` (the reference's
`detailDetection`: per level blur, downsample, upsample, blur, sum
|residual| over RGB, min-max normalise, threshold), bound here by ctypes on
its own.  `ops/kernels/build.py` compiles that source with g++ into the
build directory at first use; a failed build raises.  The on-device
training stream computes its masks on the device instead
(`ops/detail.py`), as the JAX package's does.

The wavelet masks (`wavelet_detail_masks_np`, `wavelet_pair_masks_np`):
per level one Haar step on the running approximation, max |HF| over the
three detail bands, min-max normalised, binarised at the first decile
threshold covering `target` of the pixels, and resampled nearest onto the
stage grid exactly as cv2.resize(INTER_NEAREST) does, which the JAX
package calls."""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np

from decnet_tpu_torch.ops.kernels import build

_PF = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "decnet_detail_masks": [_PF, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_float,
                            ctypes.POINTER(_PF)],
    "decnet_detail_masks_batch": [_PF, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_float,
                                  ctypes.POINTER(_PF), ctypes.c_int]}


def anisotropic_diffusion(img: np.ndarray, iterations: int = 10,
                          lamda: float = 0.1, sigma: float = 15.0
                          ) -> np.ndarray:
    """The reference's optional edge-aware pre-filter: per iteration add
    lamda * sum over the 4 neighbours of g * exp(-g^2 / sigma^2), g the
    signed difference to the neighbour (edges replicated).  As upstream,
    the differences are taken once from the input and reused every
    iteration, and their sign sharpens low-contrast texture.  (H,W) or
    (H,W,C)."""
    if iterations == 0:
        return img
    x = img.astype(np.float32)
    pad_l = np.concatenate([x[:, :1], x], axis=1)
    pad_r = np.concatenate([x, x[:, -1:]], axis=1)
    pad_t = np.concatenate([x[:1], x], axis=0)
    pad_b = np.concatenate([x, x[-1:]], axis=0)
    left_grad = (pad_r - pad_l)[:, :-1]
    right_grad = (pad_l - pad_r)[:, 1:]
    top_grad = (pad_b - pad_t)[:-1]
    bottom_grad = (pad_t - pad_b)[1:]

    def g(grad):
        return grad * np.exp(-(grad ** 2) / (sigma ** 2))

    update = g(left_grad) + g(right_grad) + g(top_grad) + g(bottom_grad)
    for _ in range(iterations):
        x = x + lamda * update
    return x


def detail_masks_np(img: np.ndarray, scale: int = 3, levels: int = 3,
                    thold: float = 0.3,
                    diffusion_iters: int = 0) -> List[np.ndarray]:
    """Binary f32 masks of img (H,W,C) float in [0,1] (H and W divisible
    by scale**levels, as the demo and the datasets pad them), after
    `diffusion_iters` iterations of `anisotropic_diffusion`; coarsest
    first ([1/scale^(levels-1), ..., full]), the model's mask order."""
    if diffusion_iters:
        img = anisotropic_diffusion(img, iterations=diffusion_iters)
    return detail_masks_batch(np.asarray(img)[None], scale, levels,
                              thold)[0]


def stereo_pair_masks(left: np.ndarray, right: np.ndarray, scale: int = 3,
                      levels: int = 3, thold: float = 0.3):
    """(left_masks, right_masks), each coarsest first."""
    return (detail_masks_np(left, scale, levels, thold),
            detail_masks_np(right, scale, levels, thold))


def detail_masks_batch(imgs: np.ndarray, scale: int = 3, levels: int = 3,
                       thold: float = 0.3) -> List[List[np.ndarray]]:
    """`detail_masks_np` of each image of imgs (N,H,W,C), one host thread
    per image (up to the host's cores); per image coarsest first."""
    imgs = np.ascontiguousarray(imgs, np.float32)
    if imgs.ndim != 4:
        raise ValueError(f"imgs must be (N,H,W,C), got {imgs.shape}")
    N, H, W, C = imgs.shape
    lib = build.load(build.HOST_LIB, _SIGNATURES, restype=None)
    outs = [[np.empty((H // scale ** i, W // scale ** i), np.float32)
             for i in range(levels)] for _ in range(N)]
    ptrs = (_PF * (N * levels))(*[o.ctypes.data_as(_PF)
                                  for per in outs for o in per])
    lib.decnet_detail_masks_batch(imgs.ctypes.data_as(_PF), N, H, W, C,
                                  scale, levels, ctypes.c_float(thold), ptrs,
                                  0)
    return [per[::-1] for per in outs]


_HAAR = (np.array([[0.5, 0.5], [-0.5, -0.5]], np.float32),    # LH
         np.array([[0.5, -0.5], [0.5, -0.5]], np.float32),    # HL
         np.array([[0.5, -0.5], [-0.5, 0.5]], np.float32))    # HH


def _wavelet_level_energies(gray: np.ndarray, levels: int
                            ) -> List[np.ndarray]:
    """Per level, finest first: max |HF| over the Haar detail bands of the
    running approximation (an odd side edge-replicated by one), raw."""
    out = []
    for _ in range(levels):
        h, w = gray.shape
        if h % 2 or w % 2:
            gray = np.pad(gray, ((0, h % 2), (0, w % 2)), mode="edge")
            h, w = gray.shape
        x = gray.reshape(h // 2, 2, w // 2, 2)
        e = None
        for f in _HAAR:
            band = np.abs(np.einsum("hiwj,ij->hw", x, f))
            e = band if e is None else np.maximum(e, band)
        gray = x.mean(axis=(1, 3))
        out.append(e)
    return out


def _decile_threshold(norms: Sequence[np.ndarray], target: float) -> float:
    """The smallest decile t whose mean fraction of pixels <= t over the
    normalised maps reaches `target`."""
    for t in np.arange(1, 11) / 10.0:
        if np.mean([(n <= t).mean() for n in norms]) >= target:
            return t
    return 1.0


def _nearest_index(src: int, dst: int) -> np.ndarray:
    """cv2.resize(INTER_NEAREST)'s source index of each of `dst` outputs:
    floor(x / (dst / src)) in double, clamped to src - 1."""
    inv = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64),
                      src - 1)


def _to_stage_grid(mask: np.ndarray, gh: int, gw: int) -> np.ndarray:
    """Nearest-resample a wavelet-grid (H/2^i) mask onto its stage grid
    (H/scale^i), as cv2.resize(mask, (gw, gh), INTER_NEAREST)."""
    yi = _nearest_index(mask.shape[0], gh)
    xi = _nearest_index(mask.shape[1], gw)
    return mask[yi][:, xi]


def wavelet_detail_masks_np(img: np.ndarray, scale: int = 3, levels: int = 3,
                            target: float = 0.85) -> List[np.ndarray]:
    """Per-image wavelet masks of img (H,W,C) in [0,1], coarsest first on
    the model's stage grids (level 1 for the full-resolution stage, level
    2 for 1/scale, ...).  Per-image thresholds break stereo consistency:
    the datasets and the demo use `wavelet_pair_masks_np`."""
    H, W = img.shape[:2]
    energies = _wavelet_level_energies(img.astype(np.float32).mean(axis=2),
                                       levels)
    masks = []
    for lev, e in enumerate(energies, start=1):
        lo, hi = e.min(), e.max()
        norm = (e - lo) / max(hi - lo, 1e-12)
        mask = (norm >= _decile_threshold([norm], target)).astype(np.float32)
        masks.append(_to_stage_grid(mask, H // scale ** (lev - 1),
                                    W // scale ** (lev - 1)))
    return masks[::-1]


def wavelet_pair_masks_np(left: np.ndarray, right: np.ndarray,
                          scale: int = 3, levels: int = 3,
                          target: float = 0.85, tar_dilate_cells: int = 1):
    """Stereo-consistent wavelet masks `(left_masks, right_masks)`, each
    coarsest first: the min-max normalisation and the decile threshold
    shared by the pair per level, and the right (target) masks dilated
    horizontally by `tar_dilate_cells` wavelet cells before resampling
    (a structure on a cell boundary in one view straddles two cells in the
    other; the right mask only gates the matcher's candidates)."""
    H, W = left.shape[:2]
    eL = _wavelet_level_energies(left.astype(np.float32).mean(axis=2), levels)
    eR = _wavelet_level_energies(right.astype(np.float32).mean(axis=2),
                                 levels)
    lms, rms = [], []
    for lev, (el, er) in enumerate(zip(eL, eR), start=1):
        lo = min(el.min(), er.min())
        hi = max(el.max(), er.max())
        nl = (el - lo) / max(hi - lo, 1e-12)
        nr = (er - lo) / max(hi - lo, 1e-12)
        th = _decile_threshold([nl, nr], target)
        rmask = nr >= th
        for _ in range(tar_dilate_cells):
            rmask = rmask | np.pad(rmask, ((0, 0), (1, 0)))[:, :-1] \
                | np.pad(rmask, ((0, 0), (0, 1)))[:, 1:]
        gh, gw = H // scale ** (lev - 1), W // scale ** (lev - 1)
        lms.append(_to_stage_grid((nl >= th).astype(np.float32), gh, gw))
        rms.append(_to_stage_grid(rmask.astype(np.float32), gh, gw))
    return lms[::-1], rms[::-1]
