"""Training augmentations (numpy, host-side) — the port of
decnet_tpu/data/augment.py: the same functions drawing from the caller's
np.random.RandomState in the same order, so a seeded sample equals the JAX
package's bit for bit.

The reference's data-level robustness injections:
* parallax-consistent glare noise  (SceneflowMask.py:255-284 add_paralex_noise)
* random mean-colour occlusion patch (KITTI15Mask.py:150-157)
* photometric contrast/gamma/brightness/colour jitter
  (KITTI15Mask.py:312-364 RandomPhotometric)
* AlexNet-style PCA lighting noise (KITTI15Mask.py:13-36 Lighting — defined
  upstream but never wired into a loader; exposed here as an optional aug)

All functions take/return float images in [0,255] (pre-normalisation), HWC.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def add_parallax_glare(left: np.ndarray, right: np.ndarray,
                       rng: np.random.RandomState,
                       max_disp_shift: int = 30) -> Tuple[np.ndarray, np.ndarray]:
    """Add an elliptical glare blob to both views, shifted by a pseudo
    disparity in the right view (parallax-consistent reflected light)."""
    h, w, _ = left.shape
    cy = rng.randint(h // 4, 3 * h // 4)
    cx = rng.randint(w // 4, 3 * w // 4)
    ry = rng.randint(h // 16, h // 6)
    rx = rng.randint(w // 16, w // 6)
    strength = rng.uniform(60, 160)
    shift = rng.randint(0, max_disp_shift)

    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]

    def blob(cx_):
        d2 = ((ys - cy) / ry) ** 2 + ((xs - cx_) / rx) ** 2
        return np.exp(-d2 * 2.0).astype(np.float32)[..., None] * strength

    out_l = np.clip(left + blob(cx), 0, 255)
    out_r = np.clip(right + blob(cx - shift), 0, 255)
    return out_l.astype(left.dtype), out_r.astype(right.dtype)


def random_occlusion_patch(right: np.ndarray, rng: np.random.RandomState
                           ) -> np.ndarray:
    """Replace a random rectangle in the right view with the image mean colour
    (KITTI15Mask.py:150-157): half-height sh ~ U(30,80), half-width
    sw ~ U(10,80), centre ~ U(s, dim-s); patch is 2sh x 2sw.  Half-sizes are
    clamped so small crops stay valid (the reference assumes KITTI-sized
    images)."""
    h, w, _ = right.shape
    sh = int(rng.uniform(30, 80))
    sw = int(rng.uniform(10, 80))
    sh = min(sh, (h - 1) // 2)
    sw = min(sw, (w - 1) // 2)
    ch = int(rng.uniform(sh, h - sh))
    cw = int(rng.uniform(sw, w - sw))
    out = right.copy()
    out[ch - sh:ch + sh, cw - sw:cw + sw] = np.mean(right, axis=(0, 1))
    return out


def random_photometric(left: np.ndarray, right: np.ndarray,
                       rng: np.random.RandomState,
                       noise_stddev: float = 0.0,
                       min_contrast: float = -0.3, max_contrast: float = 0.3,
                       brightness_stddev: float = 0.02,
                       min_color: float = 0.9, max_color: float = 1.1,
                       min_gamma: float = 0.7, max_gamma: float = 1.5
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Shared photometric jitter for both views (KITTI15Mask.py:312-364):
    contrast, per-channel colour scale, gamma, brightness, optional noise —
    identical transform applied to left and right."""
    contrast = rng.uniform(min_contrast, max_contrast) + 1.0
    gamma = rng.uniform(min_gamma, max_gamma)
    gamma_inv = 1.0 / gamma
    color = rng.uniform(min_color, max_color, 3).astype(np.float32)
    brightness = rng.normal(0, brightness_stddev)

    def apply(img):
        x = img.astype(np.float32) / 255.0
        x = x * color[None, None, :]
        x = (x - 0.5) * contrast + 0.5 + brightness
        x = np.clip(x, 0, 1) ** gamma_inv
        if noise_stddev > 0:
            x = x + rng.normal(0, noise_stddev, x.shape)
        return np.clip(x * 255.0, 0, 255).astype(img.dtype)

    return apply(left), apply(right)


# ImageNet RGB covariance eigendecomposition (KITTI15Mask.py:17-23).
_LIGHTING_EIGVAL = np.array([0.2175, 0.0188, 0.0045], dtype=np.float32)
_LIGHTING_EIGVEC = np.array([
    [-0.5675, 0.7192, 0.4009],
    [-0.5808, -0.0045, -0.8140],
    [-0.5836, -0.6948, 0.4203],
], dtype=np.float32)


def pca_lighting_noise(img: np.ndarray, rng: np.random.RandomState,
                       alphastd: float = 0.1) -> np.ndarray:
    """AlexNet-style PCA-based lighting noise (KITTI15Mask.py:13-36): add a
    random linear combination of the ImageNet RGB principal components.

    The reference operates on normalised CHW tensors; here the shift is scaled
    to this module's [0,255] HWC convention (×255)."""
    if alphastd == 0:
        return img
    alpha = rng.normal(0, alphastd, 3).astype(np.float32)
    rgb = (_LIGHTING_EIGVEC * (alpha * _LIGHTING_EIGVAL)[None, :]).sum(axis=1)
    out = img.astype(np.float32) + rgb[None, None, :] * 255.0
    return np.clip(out, 0, 255).astype(img.dtype)


def horizontal_flip_stereo(left: np.ndarray, right: np.ndarray,
                           disp_left: np.ndarray, disp_right: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stereo-consistent horizontal flip: swap the views, mirror them, and use
    the (mirrored) RIGHT disparity as the new left ground truth
    (MiddleburyMask.py:152-162)."""
    new_left = right[:, ::-1].copy()
    new_right = left[:, ::-1].copy()
    new_disp = disp_right[:, ::-1].copy()
    return new_left, new_right, new_disp
