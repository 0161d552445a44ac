"""The port's visualisation helpers (`utils/viz.py`) and the demo's
intermediates grid (`cli/demo.py --dump_intermediates 1`), on the CPU.

matplotlib exists here (not on the card's machine), so the colour tables
are held to its own, byte for byte; `disparity_histogram` and
`error_map` are held bit for bit to JAX's (decnet_tpu/utils/viz.py).  The
grid is read back by `data/io.py`; the demo runs a fresh tiny model
(base_channels 4, max_disp 54, f32) on one 54x81 scene."""
import json
import os

import numpy as np
import pytest
from matplotlib import colormaps
from matplotlib.colors import Normalize

from decnet_tpu.utils import viz as jviz
from decnet_tpu_torch.cli import demo
from decnet_tpu_torch.data import io as dio
from decnet_tpu_torch.utils import viz

# the JAX demo's panels at 4 stages (decnet_tpu/cli/demo.py:117-128)
DEMO_TITLES = ([f"pred s{i}" for i in range(4)]
               + [f"{nm} s{i}" for nm in ("dense", "sparse", "fusion",
                                          "soft_mask", "var")
                  for i in (1, 2, 3)]
               + [f"mask s{i}" for i in (1, 2, 3)])


@pytest.mark.parametrize("name", ["turbo", "gray"])
def test_tables_equal_matplotlib(name):
    want = colormaps[name](np.arange(256), bytes=True)[:, :3]
    np.testing.assert_array_equal(viz.CMAPS[name], want)


def test_colorize_is_matplotlibs_mapping():
    x = np.random.RandomState(0).randn(20, 30) * 7
    want = colormaps["turbo"](Normalize()(x), bytes=True)[..., :3]
    np.testing.assert_array_equal(viz.colorize(x), want)
    want = colormaps["turbo"](Normalize(0, 5)(x), bytes=True)[..., :3]
    np.testing.assert_array_equal(viz.colorize(x, vmin=0, vmax=5), want)


def test_show_imgs_layout_and_panels(tmp_path):
    r = np.random.RandomState(1)
    disp = r.rand(6, 9) * 40
    rgb = r.rand(6, 9, 3) * 1.4 - 0.2
    small = r.rand(2, 3)
    mask = (r.rand(6, 9) < 0.5).astype(np.float32)
    path = str(tmp_path / "grid.png")
    assert viz.show_imgs([(disp, "disp"), (rgb, "rgb"), (small, "small"),
                          (mask, "mask", "gray")], ncols=3,
                         save_path=path) == path
    img = dio.read_png(path)
    g = viz.GAP
    assert img.shape == (2 * 6 + g, 3 * 9 + 2 * g, 3)
    cell = lambda r_, c: img[r_ * (6 + g):r_ * (6 + g) + 6,
                             c * (9 + g):c * (9 + g) + 9]
    np.testing.assert_array_equal(
        cell(0, 0), colormaps["turbo"](Normalize()(disp), bytes=True)[..., :3])
    np.testing.assert_array_equal(
        cell(0, 1), (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
    # a smaller panel is scaled up by nearest neighbour
    want = colormaps["turbo"](Normalize()(small), bytes=True)[..., :3]
    np.testing.assert_array_equal(cell(0, 2), want.repeat(3, 0).repeat(3, 1))
    np.testing.assert_array_equal(cell(1, 0)[..., 0],
                                  np.where(mask > 0, 255, 0))
    # the unused cells and the gaps are white
    assert (cell(1, 1) == 255).all() and (img[6:6 + g] == 255).all()
    with open(tmp_path / "grid.json") as f:
        assert json.load(f)["titles"] == ["disp", "rgb", "small", "mask"]


def test_show_dist_bars(tmp_path):
    x, y = np.arange(4.0), np.array([1.0, 4.0, 0.0, 2.0])
    img = viz.show_dist([(x, y, "hist"), {"x": x, "y": y, "title": "pts",
                                          "color": "#ff0000",
                                          "points": ([1.0], [4.0])}],
                        ncols=2)
    H, W = viz.CHART
    assert img.shape == (H, 2 * W + viz.GAP, 3)
    first = img[:, :W]
    bar = lambda i: first[:, i * W // 4]
    heights = [int((bar(i) == viz.BAR_RGB).all(axis=1).sum()) for i in
               range(4)]
    assert heights[1] == H - 1 and heights[2] == 0
    assert heights[0] == round((H - 1) / 4) and heights[3] == round(
        (H - 1) / 2)
    second = img[:, W + viz.GAP:]
    assert (second == (255, 0, 0)).all(axis=2).any()
    assert (second == viz.POINT_RGB).all(axis=2).any()


def test_histogram_and_error_map_equal_jax():
    r = np.random.RandomState(2)
    disp = (r.rand(30, 40) * 80 - 5).astype(np.float32)
    gt = np.where(r.rand(30, 40) < 0.2, 0, disp + r.randn(30, 40)).astype(
        np.float32)
    for a, b in zip(viz.disparity_histogram(disp, 54),
                    jviz.disparity_histogram(disp, 54)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(viz.error_map(disp, gt, 54),
                                  jviz.error_map(disp, gt, 54))


def test_save_disparity_png_reads_back(tmp_path):
    disp = np.random.RandomState(3).rand(12, 20) * 30
    path = str(tmp_path / "d.png")
    viz.save_disparity_png(path, disp, vmax=40)
    got = dio.read_png(path)
    want = colormaps["turbo"](Normalize(0, 40)(disp), bytes=True)[..., :3]
    np.testing.assert_array_equal(got, want)


def test_demo_dump_intermediates(tmp_path):
    scene = tmp_path / "in" / "scene0"
    os.makedirs(scene)
    r = np.random.RandomState(4)
    for name in ("im0.png", "im1.png"):
        dio.write_png(str(scene / name),
                      (r.rand(50, 78, 3) * 255).astype(np.uint8))
    args = ["--root", str(tmp_path / "in"), "--max_disp", "54",
            "--base_channels", "4", "--set", "model.dtype=float32",
            "--device", "cpu"]
    demo.main(args + ["--save2where", str(tmp_path / "plain")])
    demo.main(args + ["--save2where", str(tmp_path / "dump"),
                      "--dump_intermediates", "1"])
    with open(tmp_path / "plain" / "scene0.png", "rb") as f, \
            open(tmp_path / "dump" / "scene0.png", "rb") as g:
        assert f.read() == g.read()
    assert not os.path.exists(tmp_path / "plain" / "scene0_check.png")
    with open(tmp_path / "dump" / "scene0_check.json") as f:
        titles = json.load(f)["titles"]
    assert titles == DEMO_TITLES and len(titles) == 22
    grid = dio.read_png(str(tmp_path / "dump" / "scene0_check.png"))
    g = viz.GAP
    # 6 rows of 4 panels at the padded 54x81
    assert grid.shape == (6 * 54 + 5 * g, 4 * 81 + 3 * g, 3)
    # the last two cells are empty; the mask panels are gray
    assert (grid[-54:, -(2 * 81 + g):] == 255).all()
    mask = grid[5 * (54 + g):5 * (54 + g) + 54, :81]
    assert (mask[..., 0] == mask[..., 1]).all()
