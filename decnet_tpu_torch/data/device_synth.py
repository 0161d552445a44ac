"""On-device synthetic stereo training batches, default variant — the port
of decnet_tpu/data/device_synth.py:38-180 and :272-391.

A batch is made on the card from a torch.Generator: a smooth disparity
background, three fronto-parallel boxes and six thin bars (1-6 px, the
detail the 1/27 stage loses), each surface carrying its own texture offset;
both views sample one procedural texture (left at x, right at x + d_r with
d_r from a z-buffer splat of the left disparity); then ImageNet
normalisation and the Gaussian-residual detail masks of `ops/detail.py`.

torch.Generator cannot reproduce jax.random's bits, so the scene is split
in two: `draw_default` makes every uniform draw, and `scene_from_draws`
(and the pieces it calls) is deterministic given the draws.  Handing both
packages the same draws gives the same batch.  The `stressor` and `legacy`
variants are not ported.

Layout: left/right (B,3,H,W) in the compute dtype, gt (B,H,W) f32, masks
(B,h_s,w_s) f32 coarsest first."""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import torch

from decnet_tpu_torch.data.io import normalize_image
from decnet_tpu_torch.ops.detail import detail_masks
from decnet_tpu_torch.ops.resize import interpolate

TEX_GAINS = (120.0, 80.0, 130.0)
BG_CELLS = 4
# (count, height range, width range, disparity range as a fraction of
# max_disp) of the boxes, the tall-narrow bars and the short-wide bars
RECTS = ((3, (1 / 8, 1 / 3), (1 / 8, 1 / 3), (0.5, 0.9)),
         (3, (0.25, 0.6), (0.004, 0.025), (0.55, 0.95)),
         (3, (0.004, 0.04), (0.15, 0.5), (0.55, 0.95)))


def texture_widths(w: int, max_disp: int) -> List[int]:
    """W-resolutions of the three texture grids over the domain
    [0, w + max_disp): coarse colour, mid detail, pixel noise."""
    wd = w + max_disp
    return [max(2, round(6 * wd / w)), max(2, round(25 * wd / w)), 2 * wd]


def draw_default(gen: torch.Generator, *, batch: int, h: int, w: int,
                 max_disp: int, device) -> Dict[str, object]:
    """Every uniform [0,1) draw of one default-variant batch: `bg`
    (B,1,5,5), `rects` nine (6,B) draws (boxes, tall bars, wide bars),
    `tex` three (B,3,min(gw,2h),gw) grids."""
    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)
    tex = [u(batch, 3, min(gw, 2 * h), gw)
           for gw in texture_widths(w, max_disp)]
    bg = u(batch, 1, BG_CELLS + 1, BG_CELLS + 1)
    rects = [u(6, batch) for n, *_ in RECTS for _ in range(n)]
    return {"bg": bg, "rects": rects, "tex": tex}


def smooth_field(grid: torch.Tensor, h: int, w: int, lo: float,
                 hi: float) -> torch.Tensor:
    """(B,h,w) bilinear upsample of a (B,1,n,n) draw, mapped to [lo, hi]."""
    v = interpolate(grid, h, w, "bilinear")[:, 0]
    return lo + (hi - lo) * v


def rect_overlay(draws: Sequence[torch.Tensor], disp: torch.Tensor,
                 off: torch.Tensor, h_rng, w_rng, d_rng, max_disp: int,
                 wd: int):
    """Paint one fronto-parallel rectangle per (6,B) draw (later wins):
    size, place, disparity and a per-surface texture offset."""
    B, H, W = disp.shape
    ys = torch.arange(H, dtype=torch.float32, device=disp.device)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=disp.device)[None, None, :]
    for u in draws:
        bh = (h_rng[0] + (h_rng[1] - h_rng[0]) * u[0]) * H
        bw = (w_rng[0] + (w_rng[1] - w_rng[0]) * u[1]) * W
        y0 = u[2] * (H - bh)
        x0 = u[3] * (W - bw)
        d = (d_rng[0] + (d_rng[1] - d_rng[0]) * u[4]) * max_disp
        o = (0.05 + 0.9 * u[5]) * wd

        def col(v):
            return v[:, None, None]
        inside = ((ys >= col(y0)) & (ys < col(y0 + bh))
                  & (xs >= col(x0)) & (xs < col(x0 + bw)))
        disp = torch.where(inside, col(d), disp)
        off = torch.where(inside, col(o), off)
    return disp, off


class TexFn:
    """Procedural texture T(x) over the domain [0, wd), sampleable at
    fractional x: each grid is resized along H to full height and sampled
    bilinearly along W at x (gw-1)/(wd-1)."""

    def __init__(self, grids: Sequence[torch.Tensor], h: int, wd: int,
                 gains=TEX_GAINS):
        self.wd = wd
        self.gains = gains
        self.grids = [interpolate(g, h, g.shape[-1], "bilinear")
                      for g in grids]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x (B,h,w) -> (B,3,h,w) in [0, 255]."""
        out = 0.0
        for g, gain in zip(self.grids, self.gains):
            gw = g.shape[-1]
            gx = x.clamp(0.0, self.wd - 1.0) * ((gw - 1.0) / (self.wd - 1.0))
            x0 = torch.floor(gx).long().clamp(0, gw - 2)
            fx = (gx - x0)[:, None]
            idx = x0[:, None].expand(-1, 3, -1, -1)
            g0 = torch.gather(g, 3, idx)
            g1 = torch.gather(g, 3, idx + 1)
            out = out + gain * (g0 * (1 - fx) + g1 * fx)
        return out.clamp(0, 255)


def right_view_disparity(disp: torch.Tensor, xs: torch.Tensor,
                         w: int) -> torch.Tensor:
    """Right-view disparity: four fixed-point steps of
    d_r(u) = d_l(u + d_r(u)), then a z-buffer (scatter-max) splat of every
    left pixel into round(x - d), nearest wins; splats more than 1 px in
    front of the fixed point override it."""
    d_r = disp
    for _ in range(4):
        xc = (xs + d_r).clamp(0.0, w - 1.0)
        x0 = torch.floor(xc).long().clamp(0, w - 2)
        fx = xc - x0
        d_r = (torch.gather(disp, 2, x0) * (1 - fx)
               + torch.gather(disp, 2, x0 + 1) * fx)
    u = torch.round(xs - disp).long()
    u = torch.where((u >= 0) & (u <= w - 1), u, w)   # w: a dropped bin
    splat = torch.full(disp.shape[:2] + (w + 1,), float("-inf"),
                       dtype=disp.dtype, device=disp.device)
    splat = splat.scatter_reduce(2, u, disp, "amax")[..., :w]
    return torch.where(splat > d_r + 1.0, splat, d_r)


def scene_from_draws(draws: Dict[str, object], *, h: int, w: int,
                     max_disp: int, scale: int = 3, levels: int = 3,
                     thold: float = 0.3,
                     dtype: torch.dtype = torch.float32) -> Dict:
    """The default-variant batch made from `draw_default`'s draws."""
    wd = w + max_disp
    disp = smooth_field(draws["bg"], h, w, 0.1 * max_disp, 0.45 * max_disp)
    off = torch.zeros_like(disp)
    rects = list(draws["rects"])
    for n, h_rng, w_rng, d_rng in RECTS:
        disp, off = rect_overlay(rects[:n], disp, off, h_rng, w_rng, d_rng,
                                 max_disp, wd)
        rects = rects[n:]
    tex = TexFn(draws["tex"], h, wd)
    xs = torch.arange(w, dtype=torch.float32,
                      device=disp.device).expand(disp.shape)
    d_r = right_view_disparity(disp, xs, w)

    def view(x):
        xo = torch.round(x).long().clamp(0, w - 1)
        o = torch.gather(off, 2, xo)
        return tex(torch.remainder(x + o, wd))

    left, right = view(xs), view(xs + d_r)
    lm = detail_masks(left / 255.0, scale, levels, thold)
    rm = detail_masks(right / 255.0, scale, levels, thold)
    return {"left": normalize_image(left / 255.0).to(dtype),
            "right": normalize_image(right / 255.0).to(dtype),
            "gt": disp.float(), "left_masks": lm, "right_masks": rm}


def make_device_batch(gen: torch.Generator, *, batch: int, h: int, w: int,
                      max_disp: int, scale: int = 3, levels: int = 3,
                      thold: float = 0.3, dtype: torch.dtype = torch.float32,
                      device="cuda") -> Dict:
    """One default-variant training batch made on `device` from `gen` (a
    torch.Generator on that device)."""
    draws = draw_default(gen, batch=batch, h=h, w=w, max_disp=max_disp,
                         device=device)
    return scene_from_draws(draws, h=h, w=w, max_disp=max_disp, scale=scale,
                            levels=levels, thold=thold, dtype=dtype)


def step_seed(seed: int, step: int, val: bool = False) -> int:
    """The generator seed of batch `step` of a stream: distinct per step,
    and disjoint between the train and the validation stream."""
    return (seed * 1_000_003 + step) * 2 + int(val)


def device_batch_stream(seed: int, *, batch: int, h: int, w: int,
                        max_disp: int, scale: int = 3, levels: int = 3,
                        thold: float = 0.3,
                        dtype: torch.dtype = torch.float32,
                        val: bool = False,
                        device="cuda") -> Iterator[Dict]:
    """Infinite iterator of batches, batch N drawn from a generator seeded
    by (seed, N), so a stream regenerates its batches.  `val=True` is a
    disjoint stream."""
    gen = torch.Generator(device=device)
    step = 0
    while True:
        gen.manual_seed(step_seed(seed, step, val))
        yield make_device_batch(gen, batch=batch, h=h, w=w,
                                max_disp=max_disp, scale=scale,
                                levels=levels, thold=thold, dtype=dtype,
                                device=device)
        step += 1
