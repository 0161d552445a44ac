"""Visualisation helpers — the port of decnet_tpu/utils/viz.py (the
reference's show_imgs / show_dis, utils/utils.py:16-143).

The card's machine has neither matplotlib nor PIL, so figures are composed
in numpy and written by `data/io.py::write_png`: a 2-D map is min-max
scaled into matplotlib's `turbo` table (or its `gray`), copied here as
256 RGB entries; an RGB image is clipped to [0, 1].  Titles and colour
bars are not drawn: `show_imgs` and `show_dist` write the panels' titles
to `<name>.json` beside the PNG (a deliberate divergence, ROADMAP.md §3).
`disparity_histogram` and `error_map` are JAX's numpy functions."""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from decnet_tpu_torch.data.io import write_png

# matplotlib's turbo colormap at its 256 levels, RGB bytes as
# `colormaps["turbo"](np.arange(256), bytes=True)` gives them
TURBO = np.frombuffer(bytes.fromhex(
    '30123b31154232184a341b51351e5836215f37236538266c3929723a2c793b2f7f3c3285'
    '3c358b3d37913e3a963f3d9c4040a14043a64145ab4148b0424bb5434eba4350be4353c2'
    '4456c74458cb455bce455ed24560d64563d94666dd4668e0466be3466de64670e84673eb'
    '4675ed4678f0467af2467df4467ff64682f84584f94587fb4589fc448cfd438efd4291fe'
    '4193fe4096fe3f98fe3e9bfe3c9dfd3ba0fc39a2fc38a5fb36a8f934aaf833acf631aff5'
    '2fb1f32db4f12bb6ef2ab9ed28bbeb26bde925c0e623c2e421c4e120c6df1ec9dc1dcbda'
    '1ccdd71bcfd41ad1d219d3cf18d5cc18d7ca17d9c717dac417dcc217debf18e0bd18e1ba'
    '19e3b81ae4b61be5b41de7b11ee8af20e9ac22eba924eca627eda329eea02cef9d2ff09a'
    '32f19735f39438f4913bf48d3ff58a42f68746f7834af8804df97c51f97955fa7659fb72'
    '5dfb6f61fc6c65fc6869fd656dfd6271fd5f74fe5c78fe597cfe5680fe5384fe5087fe4d'
    '8bfe4b8efe4892fe4695fe4498fe429bfd409efd3ea1fc3da4fc3ba6fb3aa9fb39acfa37'
    'aef937b1f836b3f835b6f735b9f534bbf434bef334c0f233c3f133c5ef33c8ee33caed33'
    'cdeb34cfea34d1e834d4e735d6e535d8e335dae236dde036dfde36e1dc37e3da37e5d838'
    'e7d738e8d538ead339ecd139edcf39efcd39f0cb3af2c83af3c63af4c43af6c23af7c039'
    'f8be39f9bc39f9ba38fab737fbb537fbb336fcb035fcae34fdab33fda932fda631fda330'
    'fea12ffe9e2efe9b2dfe982cfd952bfd9229fd8f28fd8c27fc8926fc8624fb8323fb8022'
    'fa7d20fa7a1ff9771ef8741cf7711bf76e1af66b18f56817f46516f36315f26014f15d13'
    'ef5a11ee5810ed550fec520eea500de94d0de84b0ce6490be5460ae3440ae24209e04008'
    'de3e08dd3c07db3a07d93806d73606d63405d43205d23005d02f04ce2d04cb2b03c92903'
    'c72803c52602c32402c02302be2102bb1f01b91e01b61c01b41b01b11901ae1801ac1601'
    'a91501a61401a31201a011019d10019a0e01970d01940c01910b018e0a018b0901870801'
    '8407018106027d05027a0402'
), np.uint8).reshape(256, 3)
# matplotlib's gray at 256 levels: (linspace(0, 1, 256) * 255) truncated
GRAY = np.repeat((np.linspace(0.0, 1.0, 256) * 255).astype(np.uint8)[:, None],
                 3, axis=1)
CMAPS = {"turbo": TURBO, "gray": GRAY}
BAR_RGB = (31, 119, 180)      # matplotlib's first colour cycle entry, C0
POINT_RGB = (220, 20, 60)     # crimson
BACKGROUND = 255
GAP = 4                       # px between panels
CHART = (120, 200)            # a bar chart's panel, H x W


def colorize(arr: np.ndarray, cmap: str = "turbo",
             vmin: Optional[float] = None,
             vmax: Optional[float] = None) -> np.ndarray:
    """(H,W,3) uint8 of a 2-D map through `cmap` as matplotlib maps it:
    x -> (x - vmin) / (vmax - vmin) (the map's min and max by default;
    0 where they are equal), level min(floor(256 x), 255) clipped to
    [0, 255]; NaN black."""
    a = np.asarray(arr, np.float64)
    finite = a[np.isfinite(a)]
    lo = vmin if vmin is not None else (
        float(finite.min()) if finite.size else 0.0)
    hi = vmax if vmax is not None else (
        float(finite.max()) if finite.size else lo)
    x = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
    idx = np.clip(np.floor(np.nan_to_num(x, nan=0.0) * 256), 0, 255)
    rgb = CMAPS[cmap][idx.astype(np.int64)]
    rgb[~np.isfinite(a)] = 0
    return rgb


def _as_rgb(arr: np.ndarray, cmap: Optional[str]) -> np.ndarray:
    """A panel's pixels: a 2-D map colourised, RGB(A) floats clipped to
    [0, 1] and scaled to bytes, uint8 RGB(A) as it is (alpha dropped)."""
    a = np.asarray(arr)
    if a.ndim == 2:
        return colorize(a, cmap or "turbo")
    a = a[..., :3]
    if a.dtype.kind == "f":
        return (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)
    return a.astype(np.uint8)


def _fit(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """`img` resized to h x w by nearest neighbour."""
    rows = np.arange(h) * img.shape[0] // h
    cols = np.arange(w) * img.shape[1] // w
    return img[rows][:, cols]


def _grid(panels: Sequence[np.ndarray], ncols: int) -> np.ndarray:
    """Panels of one size in rows of `ncols`, GAP px apart on white."""
    n = len(panels)
    ncols = min(ncols, n)
    nrows = -(-n // ncols)
    h, w = panels[0].shape[:2]
    out = np.full((nrows * h + (nrows - 1) * GAP,
                   ncols * w + (ncols - 1) * GAP, 3), BACKGROUND, np.uint8)
    for i, p in enumerate(panels):
        r, c = divmod(i, ncols)
        out[r * (h + GAP):r * (h + GAP) + h,
            c * (w + GAP):c * (w + GAP) + w] = p
    return out


def _save(save_path: str, img: np.ndarray, titles: Sequence[str]) -> str:
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    write_png(save_path, img)
    with open(os.path.splitext(save_path)[0] + ".json", "w") as f:
        json.dump({"titles": list(titles), "shape": list(img.shape)}, f,
                  indent=1)
    return save_path


def show_imgs(img_list: Sequence[Union[np.ndarray, Tuple]],
              ncols: int = 3, save_path: Optional[str] = None):
    """Grid of images and maps, row by row in the list's order.  Entries
    are arrays or (array, title[, cmap]) tuples, as the reference's.  Each
    panel is scaled by nearest neighbour to the largest panel's size.
    Returns the (H,W,3) uint8 grid, or with `save_path` writes it there
    (PNG) with the titles in the .json beside it and returns the path."""
    items = []
    for it in img_list:
        if isinstance(it, tuple):
            arr = np.asarray(it[0])
            title = it[1] if len(it) > 1 else ""
            cmap = it[2] if len(it) > 2 else None
        else:
            arr, title, cmap = np.asarray(it), "", None
        items.append((_as_rgb(arr, cmap), title))
    h = max(p.shape[0] for p, _ in items)
    w = max(p.shape[1] for p, _ in items)
    img = _grid([_fit(p, h, w) for p, _ in items], ncols)
    if save_path:
        return _save(save_path, img, [t for _, t in items])
    return img


def _color(c: Optional[str]) -> Tuple[int, int, int]:
    """An RGB byte triple from None (C0) or '#rrggbb'."""
    if c is None:
        return BAR_RGB
    if not (isinstance(c, str) and c.startswith("#") and len(c) == 7):
        raise ValueError(f"colour {c!r}: give '#rrggbb'")
    return tuple(int(c[i:i + 2], 16) for i in (1, 3, 5))


def _bar_chart(x, y, color=None, points=None) -> np.ndarray:
    """A CHART-sized raster of bars of height y (scaled to the largest;
    negative heights are drawn as 0), one bar per x in order, and the
    optional (px, py) points as 3x3 crimson squares."""
    H, W = CHART
    y = np.maximum(np.asarray(y, np.float64), 0.0)
    img = np.full((H, W, 3), BACKGROUND, np.uint8)
    top = max(float(y.max()) if y.size else 0.0,
              float(np.max(points[1])) if points is not None else 0.0)
    n = len(y)
    if n == 0 or top <= 0:
        return img
    edges = np.linspace(0, W, n + 1).astype(int)
    for i, v in enumerate(y):
        bh = int(round(v / top * (H - 1)))
        if bh:
            img[H - bh:, edges[i]:max(edges[i + 1] - 1, edges[i] + 1)] = \
                _color(color)
    if points is not None:
        xs = np.asarray(x, np.float64)
        span = (xs.min(), xs.max()) if xs.size else (0.0, 1.0)
        for px, py in zip(*points):
            cx = int(round((px - span[0]) / max(span[1] - span[0], 1e-12)
                           * (W - 1)))
            cy = H - 1 - int(round(max(py, 0.0) / top * (H - 1)))
            img[max(cy - 1, 0):cy + 2, max(cx - 1, 0):cx + 2] = POINT_RGB
    return img


def show_dist(charts: Sequence[Union[Tuple, dict]], ncols: int = 3,
              save_path: Optional[str] = None):
    """Grid of bar charts (disparity histograms, per-stage statistics),
    the reference's show_dis.  Entries are (x, y, title[, color]) tuples
    or {"x", "y", "title", "color", "points"} dicts, points an optional
    (px, py) overlay.  Returns the grid, or writes it as `show_imgs`."""
    items = []
    for it in charts:
        items.append(it if isinstance(it, dict)
                     else dict(zip(("x", "y", "title", "color"), it)))
    img = _grid([_bar_chart(c["x"], c["y"], c.get("color"), c.get("points"))
                 for c in items], ncols)
    if save_path:
        return _save(save_path, img, [c.get("title", "") for c in items])
    return img


def disparity_histogram(disp: np.ndarray, max_disp: float, bins: int = 48):
    """(x, y) bar-chart data of a disparity map's valid-pixel distribution."""
    valid = disp[(disp > 0) & (disp < max_disp)]
    y, edges = np.histogram(valid, bins=bins, range=(0.0, float(max_disp)))
    return (edges[:-1] + edges[1:]) / 2.0, y


def save_disparity_png(path: str, disp: np.ndarray,
                       vmax: Optional[float] = None):
    """Colorised disparity visualisation (not the uint16 submission
    format): turbo from 0 to `vmax` (the map's maximum by default)."""
    write_png(path, colorize(disp, "turbo", vmin=0.0, vmax=vmax))


def error_map(pred: np.ndarray, gt: np.ndarray, max_disp: float
              ) -> np.ndarray:
    """Signed error with invalid pixels zeroed, for show_imgs."""
    valid = (gt > 0) & (gt < max_disp)
    return np.where(valid, pred - gt, 0.0)
