"""On-device synthetic stereo training batches — the port of
decnet_tpu/data/device_synth.py:38-391, with its three variants.

A batch is made on the card from a torch.Generator: a smooth disparity
background, three fronto-parallel boxes and six thin bars (1-6 px, the
detail the 1/27 stage loses), each surface carrying its own texture offset;
both views sample one procedural texture (left at x, right at x + d_r with
d_r from a z-buffer splat of the left disparity); then ImageNet
normalisation and the Gaussian-residual detail masks of `ops/detail.py`.

Variants: "default" as above; "legacy", the round-4 renderer, whose right
view takes the fixed-point disparity alone (no splat, so thin bars never
reach the right view); "stressor", thin bars 0.55-0.9 max_disp over a low
smooth background textured by a periodic sinusoid, so that only full-band
matching can find the bars' disparity (`stressor_from_draws`).

torch.Generator cannot reproduce jax.random's bits, so the scene is split
in two: `draw_default` / `draw_stressor` make every uniform draw, and
`scene_from_draws` / `stressor_from_draws` (and the pieces they call) are
deterministic given the draws.  Handing both packages the same draws gives
the same batch.

Layout: left/right (B,3,H,W) in the compute dtype, gt (B,H,W) f32, masks
(B,h_s,w_s) f32 coarsest first."""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from decnet_tpu_torch.config import VARIANTS
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
# the stressor's tall-narrow and short-wide bars, its texture gains, the
# sinusoid's period (px) and its two components' amplitudes
STRESSOR_RECTS = ((6, (0.3, 0.8), (0.004, 0.02), (0.55, 0.9)),
                  (2, (0.006, 0.02), (0.15, 0.45), (0.55, 0.9)))
STRESSOR_GAINS = (120.0, 80.0, 200.0)
STRESSOR_PERIOD = 24.0
STRESSOR_WAVES = (45.0, 25.0)


def texture_widths(w: int, max_disp: int) -> List[int]:
    """W-resolutions of the three texture grids over the domain
    [0, w + max_disp): coarse colour, mid detail, pixel noise."""
    wd = w + max_disp
    return [max(2, round(6 * wd / w)), max(2, round(25 * wd / w)), 2 * wd]


def draw_default(gen: torch.Generator, *, batch: int, h: int, w: int,
                 max_disp: int, device, rects=RECTS) -> Dict[str, object]:
    """Every uniform [0,1) draw of one default-variant (or legacy) batch:
    `bg` (B,1,5,5), `rects` one (6,B) draw per rectangle of `rects` (boxes,
    tall bars, wide bars), `tex` three (B,3,min(gw,2h),gw) grids."""
    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)
    tex = [u(batch, 3, min(gw, 2 * h), gw)
           for gw in texture_widths(w, max_disp)]
    bg = u(batch, 1, BG_CELLS + 1, BG_CELLS + 1)
    rects = [u(6, batch) for n, *_ in rects for _ in range(n)]
    return {"bg": bg, "rects": rects, "tex": tex}


def draw_stressor(gen: torch.Generator, *, batch: int, h: int, w: int,
                  max_disp: int, device) -> Dict[str, object]:
    """Every uniform draw of one stressor batch: those of `draw_default`
    with the stressor's eight bars, and `phases` (2,B,3,1,1), the two
    sinusoids' phases per colour channel as fractions of a turn."""
    draws = draw_default(gen, batch=batch, h=h, w=w, max_disp=max_disp,
                         device=device, rects=STRESSOR_RECTS)
    draws["phases"] = torch.rand((2, batch, 3, 1, 1), generator=gen,
                                 device=device)
    return draws


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

    def component(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Grid i sampled at x (B,h,w), times its gain: (B,3,h,w)."""
        g, gw = self.grids[i], self.grids[i].shape[-1]
        gx = x.clamp(0.0, self.wd - 1.0) * ((gw - 1.0) / (self.wd - 1.0))
        x0 = torch.floor(gx).long().clamp(0, gw - 2)
        fx = (gx - x0)[:, None]
        idx = x0[:, None].expand(-1, 3, -1, -1)
        g0 = torch.gather(g, 3, idx)
        g1 = torch.gather(g, 3, idx + 1)
        return self.gains[i] * (g0 * (1 - fx) + g1 * fx)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x (B,h,w) -> (B,3,h,w) in [0, 255]."""
        out = 0.0
        for i in range(len(self.grids)):
            out = out + self.component(i, x)
        return out.clamp(0, 255)


def fixed_point_disparity(disp: torch.Tensor, xs: torch.Tensor,
                          w: int) -> torch.Tensor:
    """Four fixed-point steps of d_r(u) = d_l(u + d_r(u)), d_l sampled
    linearly: the right-view disparity of the legacy renderer."""
    d_r = disp
    for _ in range(4):
        xc = (xs + d_r).clamp(0.0, w - 1.0)
        x0 = torch.floor(xc).long().clamp(0, w - 2)
        fx = xc - x0
        d_r = (torch.gather(disp, 2, x0) * (1 - fx)
               + torch.gather(disp, 2, x0 + 1) * fx)
    return d_r


def right_view_disparity(disp: torch.Tensor, xs: torch.Tensor,
                         w: int) -> torch.Tensor:
    """Right-view disparity: `fixed_point_disparity`, then a z-buffer
    (scatter-max) splat of every left pixel into round(x - d), nearest
    wins; splats more than 1 px in front of the fixed point override it."""
    d_r = fixed_point_disparity(disp, xs, w)
    u = torch.round(xs - disp).long()
    u = torch.where((u >= 0) & (u <= w - 1), u, w)   # w: a dropped bin
    splat = torch.full(disp.shape[:2] + (w + 1,), float("-inf"),
                       dtype=disp.dtype, device=disp.device)
    splat = splat.scatter_reduce(2, u, disp, "amax")[..., :w]
    return torch.where(splat > d_r + 1.0, splat, d_r)


def finish_batch(left: torch.Tensor, right: torch.Tensor, disp: torch.Tensor,
                 scale: int, levels: int, thold: float,
                 dtype: torch.dtype) -> Dict:
    """The batch of two [0, 255] views and the disparity: ImageNet-
    normalised views in `dtype`, gt in f32 and both views' detail masks."""
    lm = detail_masks(left / 255.0, scale, levels, thold)
    rm = detail_masks(right / 255.0, scale, levels, thold)
    return {"left": normalize_image(left / 255.0).to(dtype),
            "right": normalize_image(right / 255.0).to(dtype),
            "gt": disp.float(), "left_masks": lm, "right_masks": rm}


def scene_from_draws(draws: Dict[str, object], *, h: int, w: int,
                     max_disp: int, scale: int = 3, levels: int = 3,
                     thold: float = 0.3, dtype: torch.dtype = torch.float32,
                     legacy: bool = False) -> Dict:
    """The default-variant batch made from `draw_default`'s draws; with
    `legacy` the right view takes `fixed_point_disparity` alone."""
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
    d_r = (fixed_point_disparity if legacy else right_view_disparity)(
        disp, xs, w)

    def view(x):
        xo = torch.round(x).long().clamp(0, w - 1)
        o = torch.gather(off, 2, xo)
        return tex(torch.remainder(x + o, wd))

    return finish_batch(view(xs), view(xs + d_r), disp, scale, levels, thold,
                        dtype)


def stressor_from_draws(draws: Dict[str, object], *, h: int, w: int,
                        max_disp: int, scale: int = 3, levels: int = 3,
                        thold: float = 0.3,
                        dtype: torch.dtype = torch.float32) -> Dict:
    """The stressor batch made from `draw_stressor`'s draws: the bars
    carry a high-gain noise texture (surface-attached, so matchable); the
    background (texture offset 0) carries the coarse colour component and
    two sinusoids of period 24 and 12 px, locally smooth and globally
    repetitive, so no local window disambiguates a large shift."""
    wd = w + max_disp
    disp = smooth_field(draws["bg"], h, w, 0.08 * max_disp, 0.22 * max_disp)
    off = torch.zeros_like(disp)
    rects = list(draws["rects"])
    for n, h_rng, w_rng, d_rng in STRESSOR_RECTS:
        disp, off = rect_overlay(rects[:n], disp, off, h_rng, w_rng, d_rng,
                                 max_disp, wd)
        rects = rects[n:]
    tex = TexFn(draws["tex"], h, wd, STRESSOR_GAINS)
    phases = draws["phases"] * (2 * math.pi)

    def bg_tex(x):
        xx = x[:, None]
        wave = (STRESSOR_WAVES[0] * torch.sin(
                    2 * math.pi * xx / STRESSOR_PERIOD + phases[0])
                + STRESSOR_WAVES[1] * torch.sin(
                    2 * math.pi * xx / (STRESSOR_PERIOD / 2.0) + phases[1]))
        return (tex.component(0, x) + wave).clamp(0, 255)

    xs = torch.arange(w, dtype=torch.float32,
                      device=disp.device).expand(disp.shape)
    d_r = right_view_disparity(disp, xs, w)

    def view(x):
        xo = torch.round(x).long().clamp(0, w - 1)
        o = torch.gather(off, 2, xo)
        fg = tex(torch.remainder(x + o, wd))
        return torch.where((o > 0)[:, None], fg, bg_tex(x))

    return finish_batch(view(xs), view(xs + d_r), disp, scale, levels, thold,
                        dtype)


def make_device_batch(gen: torch.Generator, *, batch: int, h: int, w: int,
                      max_disp: int, scale: int = 3, levels: int = 3,
                      thold: float = 0.3, dtype: torch.dtype = torch.float32,
                      device="cuda", variant: str = "default") -> Dict:
    """One training batch of `variant` made on `device` from `gen` (a
    torch.Generator on that device)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    kw = dict(batch=batch, h=h, w=w, max_disp=max_disp, device=device)
    scene = dict(h=h, w=w, max_disp=max_disp, scale=scale, levels=levels,
                 thold=thold, dtype=dtype)
    if variant == "stressor":
        return stressor_from_draws(draw_stressor(gen, **kw), **scene)
    return scene_from_draws(draw_default(gen, **kw), **scene,
                            legacy=variant == "legacy")


def step_seed(seed: int, step: int, val: bool = False) -> int:
    """The generator seed of batch `step` of a stream: distinct per step,
    and disjoint between the train and the validation stream."""
    return (seed * 1_000_003 + step) * 2 + int(val)


def device_batch_stream(seed: int, *, batch: int, h: int, w: int,
                        max_disp: int, scale: int = 3, levels: int = 3,
                        thold: float = 0.3,
                        dtype: torch.dtype = torch.float32,
                        val: bool = False, device="cuda",
                        variant: str = "default",
                        start_step: int = 0) -> Iterator[Dict]:
    """Infinite iterator of batches of `variant`, batch N drawn from a
    generator seeded by (seed, N), so a stream regenerates its batches.
    `val=True` is a disjoint stream.  `start_step` k starts at batch k: a
    resumed run sees the batches an unbroken one would."""
    gen = torch.Generator(device=device)
    step = start_step
    while True:
        gen.manual_seed(step_seed(seed, step, val))
        yield make_device_batch(gen, batch=batch, h=h, w=w,
                                max_disp=max_disp, scale=scale,
                                levels=levels, thold=thold, dtype=dtype,
                                device=device, variant=variant)
        step += 1


def saved_draw_stream(path: str, *, seed: int, batch: int, h: int, w: int,
                      max_disp: int, dtype: torch.dtype = torch.float32,
                      device="cuda",
                      variant: str = "default") -> Iterator[Dict]:
    """The default or legacy val batches of saved scenes: an npz of
    `draw_default`'s draws but the per-pixel noise grid, one row per batch
    (`bg` (N,B,1,5,5), `rects` (N,9,6,B), `tex0`, `tex1` (N,B,3,rows,gw)),
    with `shape` = [B, h, w, max_disp]; e.g. the JAX report stream's scenes
    (`python -m tests.test_torch_synth_variants --dump`).  The noise grid
    of batch N is drawn here as `device_batch_stream(seed, val=True)` draws
    it, so batch N differs from that stream's in its scene alone."""
    if variant not in ("default", "legacy"):
        raise ValueError(f"saved draws hold default or legacy scenes, not "
                         f"{variant!r}")
    saved = np.load(path)
    if list(saved["shape"]) != [batch, h, w, max_disp]:
        raise ValueError(f"{path} holds batches of [B, h, w, max_disp] = "
                         f"{list(saved['shape'])}, not "
                         f"{[batch, h, w, max_disp]}")
    gen = torch.Generator(device=device)
    for step in range(saved["bg"].shape[0]):
        gen.manual_seed(step_seed(seed, step, True))
        draws = draw_default(gen, batch=batch, h=h, w=w, max_disp=max_disp,
                             device=device)
        draws["bg"] = torch.from_numpy(saved["bg"][step]).to(device)
        draws["rects"] = list(torch.from_numpy(saved["rects"][step])
                              .to(device))
        draws["tex"][:2] = [torch.from_numpy(saved[k][step]).to(device)
                            for k in ("tex0", "tex1")]
        yield scene_from_draws(draws, h=h, w=w, max_disp=max_disp,
                               dtype=dtype, legacy=variant == "legacy")
