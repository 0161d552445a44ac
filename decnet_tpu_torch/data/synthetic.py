"""Synthetic stereo data on the host.

`synthetic_pair`: seeded synthetic stereo requests for smoke runs and
profiles.  Not the JAX package's training stream
(decnet_tpu/data/device_synth.py); it borrows that stream's texture gains
so that the faithful checkpoint sees images of the kind it was trained on.

`Synthetic`: the port of decnet_tpu/data/synthetic.py, the host twin of
the on-device stream as a dataset (name "synthetic"): per index a numpy
RandomState seeded by the split's base seed plus the index draws a smooth
background, boxes and thin bars with per-surface texture offsets, and a
procedural texture both views sample (left at x, right at x + d_right);
the same numpy draws as the JAX package's, so the same samples."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from decnet_tpu_torch.data.datasets import StereoDataset, _DATASETS
from decnet_tpu_torch.ops.resize import _resize_matrix


def synthetic_pair(H: int, W: int, gen: torch.Generator, device="cuda"
                   ) -> Tuple[torch.Tensor, ...]:
    """A random-texture right image and a left image warped from it by a
    piecewise-constant disparity field in [8, 180]: a fronto-parallel
    background plane and four nearer rectangles.

    Returns (left, right) (1,3,H,W) in [0,1], the left view's disparity
    (1,H,W) and the mask of left pixels whose match lies inside the right
    image.  `gen` is a torch.Generator on `device`."""
    # coarse colour, mid detail and pixel noise, with the gains of the
    # checkpoint's training stream
    tex = torch.zeros(1, 3, H, W, device=device)
    for cells, gain in ((6, 120.0), (25, 80.0), (2 * W, 130.0)):
        noise = torch.rand(1, 3, min(cells, 2 * H), cells, generator=gen,
                           device=device)
        tex += gain / 255.0 * F.interpolate(noise, size=(H, W),
                                            mode="bilinear",
                                            align_corners=False)

    def uniform(lo, hi):
        u = float(torch.rand(1, generator=gen, device=device))
        return lo + (hi - lo) * u

    disp = torch.full((1, H, W), float(round(uniform(8, 60))), device=device)
    for _ in range(4):
        h, w = int(uniform(H / 8, H / 3)), int(uniform(W / 8, W / 3))
        y, x = int(uniform(0, H - h)), int(uniform(0, W - w))
        disp[:, y:y + h, x:x + w] = float(round(uniform(60, 180)))
    src = torch.arange(W, device=device).view(1, 1, W) - disp.long()
    valid = src >= 0
    idx = src.clamp(min=0)[:, None].expand(1, 3, H, W)
    left = torch.gather(tex, 3, idx)
    return left.clamp(0, 1), tex.clamp(0, 1), disp, valid


def _smooth_field(rng, h, w, cells, lo, hi):
    """(h,w) bilinear upsample of a random (cells+1)^2 grid in [lo,hi]."""
    g = rng.rand(cells + 1, cells + 1).astype(np.float32)
    my = _resize_matrix(cells + 1, h, "bilinear")
    mx = _resize_matrix(cells + 1, w, "bilinear")
    v = my @ g @ mx.T
    return lo + (hi - lo) * v


def _tex_grids(rng, h, w, wd) -> List[Tuple[np.ndarray, float]]:
    """Texture component grids, pre-resized along H (W stays native).

    The domain spans wd = w + max_disp columns (counts scale with wd/w so
    feature size is w-independent) so the right view is fully textured —
    see device_synth._TexFn for why the old black trailing band collapsed
    right-mask density ~40x."""
    grids = []
    for gw, gain in ((max(2, round(6 * wd / w)), 120.0),
                     (max(2, round(25 * wd / w)), 80.0), (2 * wd, 130.0)):
        gh = min(gw, 2 * h)
        g = rng.rand(gh, gw, 3).astype(np.float32)
        my = _resize_matrix(gh, h, "bilinear")
        grids.append((np.einsum("oh,hwc->owc", my, g), gain))
    return grids


def _tex(grids, x, wd):
    """Sample the texture function at fractional x (h,w) -> (h,w,3)."""
    h = x.shape[0]
    rows = np.arange(h)[:, None]
    out = 0.0
    for g, gain in grids:
        gw = g.shape[1]
        gx = np.clip(x, 0.0, wd - 1.0) * ((gw - 1.0) / (wd - 1.0))
        x0 = np.clip(np.floor(gx).astype(np.int64), 0, gw - 2)
        fx = (gx - x0)[..., None].astype(np.float32)
        out = out + gain * (g[rows, x0] * (1 - fx) + g[rows, x0 + 1] * fx)
    return np.clip(out, 0, 255)


def _rect_overlay(rng, disp, off, n, h_rng, w_rng, d_rng, max_disp, wd):
    """Overlay n fronto-parallel rectangles (device_synth._rect_overlay).
    Each rectangle also paints a per-surface texture offset into `off` so
    depth edges have appearance in both views (see the device twin)."""
    h, w = disp.shape
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    for _ in range(n):
        u = rng.rand(6).astype(np.float32)
        bh = (h_rng[0] + (h_rng[1] - h_rng[0]) * u[0]) * h
        bw = (w_rng[0] + (w_rng[1] - w_rng[0]) * u[1]) * w
        y0 = u[2] * (h - bh)
        x0 = u[3] * (w - bw)
        d = (d_rng[0] + (d_rng[1] - d_rng[0]) * u[4]) * max_disp
        o = (0.05 + 0.9 * u[5]) * wd
        inside = (ys >= y0) & (ys < y0 + bh) & (xs >= x0) & (xs < x0 + bw)
        disp = np.where(inside, np.float32(d), disp)
        off = np.where(inside, np.float32(o), off)
    return disp, off


def make_pair(rng: np.random.RandomState, h: int, w: int, max_disp: int
              ) -> Dict[str, np.ndarray]:
    """Returns dict(left, right (H,W,3) in [0,255], gt (H,W)) — the numpy
    twin of device_synth.make_device_batch (same scene distribution)."""
    # disparity: smooth background + boxes + thin bars (fine detail);
    # rectangles carry per-surface texture offsets (see device twin)
    wd = w + max_disp
    disp = _smooth_field(rng, h, w, 4, 0.1 * max_disp, 0.45 * max_disp)
    off = np.zeros_like(disp, np.float32)
    disp, off = _rect_overlay(rng, disp, off, 3, (1 / 8, 1 / 3),
                              (1 / 8, 1 / 3), (0.5, 0.9), max_disp, wd)
    disp, off = _rect_overlay(rng, disp, off, 3, (0.25, 0.6), (0.004, 0.025),
                              (0.55, 0.95), max_disp, wd)
    disp, off = _rect_overlay(rng, disp, off, 3, (0.004, 0.04), (0.15, 0.5),
                              (0.55, 0.95), max_disp, wd)
    disp = disp.astype(np.float32)

    # right-view disparity: fixed point d_r(u) = d_l(u + d_r(u)) so left
    # pixel x truly matches right pixel x - d_l(x) (occlusions excepted)
    xs = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :], disp.shape)
    rows = np.arange(h)[:, None]

    def sample_w(f, x):
        xc = np.clip(x, 0.0, w - 1.0)
        x0 = np.clip(np.floor(xc).astype(np.int64), 0, w - 2)
        fx = (xc - x0).astype(np.float32)
        return f[rows, x0] * (1 - fx) + f[rows, x0 + 1] * fx

    d_r = disp
    for _ in range(4):
        d_r = sample_w(disp, xs + d_r)

    grids = _tex_grids(rng, h, w, wd)

    def view(x):
        """Composite scene function: texture at x + surface offset(x)."""
        xo = np.clip(np.round(x).astype(np.int64), 0, w - 1)
        o = off[rows, xo]
        return _tex(grids, np.mod(x + o, wd), wd).astype(np.float32)

    left = view(xs)
    right = view(xs + d_r)
    return {"left": left, "right": right, "gt": disp}


class Synthetic(StereoDataset):
    def __init__(self, root: str = "", split: str = "train", length: int = 64,
                 max_disp: int = 192, **kw):
        kw.setdefault("augment_cfg", {"glare": False})
        super().__init__(root, split, **kw)
        self.length = length
        self.max_disp_gen = max_disp
        self.base_seed = {"train": 0, "val": 10_000,
                          "test": 20_000}.get(split, 0)

    def __len__(self):
        return self.length

    def _load_raw(self, index):
        rng = np.random.RandomState(self.base_seed + index)
        h = int(np.ceil(self.img_size[0] / self.interval) * self.interval)
        w = int(np.ceil(self.img_size[1] / self.interval) * self.interval)
        d = make_pair(rng, h, w, min(self.max_disp_gen, w // 2))
        d["name"] = f"syn{self.base_seed + index:06d}"
        d["ndisp"] = self.max_disp_gen
        return d


_DATASETS["synthetic"] = Synthetic
