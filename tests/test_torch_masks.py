"""The demo's host detail masks in the port (`data/masks.py`, its own build
of native/decnet_native.cc) against the JAX package's
`data/masks.py::detail_masks_np`, which the JAX demo calls; and the port's
demo CLI serving with them.

Both sides run the same C++ source, compiled by two builds (the port's with
g++ -O3 for the baseline instruction set, the JAX package's prebuilt
library with -march=native); on these seeded images the masks are equal in
every pixel."""
import os

import numpy as np
import pytest
import torch

from decnet_tpu.data import io as jio
from decnet_tpu.data import masks as jmasks
from decnet_tpu_torch.cli import demo
from decnet_tpu_torch.config import Config, ModelConfig
from decnet_tpu_torch.data import masks as tmasks
from decnet_tpu_torch.models import DecNet
from decnet_tpu_torch.train.checkpoint import save_params
from tests.test_torch_model import FAITHFUL_SMALL


def jax_demo_masks(img_u8):
    """The JAX demo's masks of one uint8 (H,W,3) image (cli/demo.py:96-105)."""
    lp = jio.pad_to_multiple(img_u8.astype(np.float32) / 255.0, 27)
    return jmasks.detail_masks_np(lp, 3, 3, 0.3)


@pytest.mark.parametrize("H,W", [(54, 81), (540, 972)])
def test_detail_masks_np_matches_jax(H, W):
    img = np.random.RandomState(H).rand(H, W, 3).astype(np.float32)
    got = tmasks.detail_masks_np(img, 3, 3, 0.3)
    want = jmasks.detail_masks_np(img, 3, 3, 0.3)
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (H // 9, W // 9), (H // 3, W // 3), (H, W)]
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, w)
        assert 0.0 < g.mean() < 1.0


def test_batch_equals_single_images():
    imgs = np.random.RandomState(1).rand(3, 27, 54, 3).astype(np.float32)
    for img, per in zip(imgs, tmasks.detail_masks_batch(imgs, 3, 3, 0.4)):
        for a, b in zip(per, tmasks.detail_masks_np(img, 3, 3, 0.4)):
            assert np.array_equal(a, b)


def test_host_masks_equal_jax_demo():
    """`demo.host_masks` pads as `predict` does (top and left, to x27) and
    computes each image's masks as the JAX demo does."""
    rng = np.random.RandomState(2)
    imgs = (rng.rand(2, 2, 50, 70, 3) * 255).astype(np.uint8)
    t = [torch.from_numpy(side).permute(0, 3, 1, 2).float() / 255.0
         for side in imgs]
    cfg = ModelConfig(**FAITHFUL_SMALL)
    got = demo.host_masks(t[0], t[1], cfg)
    for side, masks in zip(imgs, got):
        assert [m.shape for m in masks] == [(2, 6, 9), (2, 18, 27),
                                           (2, 54, 81)]
        for b in range(2):
            for g, w in zip(masks, jax_demo_masks(side[b])):
                assert np.array_equal(g[b].numpy(), w)


def test_demo_cli_serves_host_masks(tmp_path, monkeypatch):
    """The demo CLI on a scene folder: its model gets the JAX demo's masks
    and it writes the uint16 disparity PNG."""
    from PIL import Image
    torch.manual_seed(0)
    cfg = ModelConfig(**FAITHFUL_SMALL, dtype="float32")
    ckpt = tmp_path / "ckpt"
    full = Config()
    full.model = cfg
    save_params(str(ckpt), DecNet(cfg), full)
    scene = tmp_path / "in" / "s0"
    scene.mkdir(parents=True)
    rng = np.random.RandomState(3)
    pair = (rng.rand(2, 54, 81, 3) * 255).astype(np.uint8)
    for name, img in zip(("im0.png", "im1.png"), pair):
        Image.fromarray(img).save(scene / name)
    seen = []
    real = demo.predict

    def spy(model, left, right, lmasks, rmasks, max_disp):
        seen.append((lmasks, rmasks))
        return real(model, left, right, lmasks, rmasks, max_disp)

    monkeypatch.setattr(demo, "predict", spy)
    out = tmp_path / "out"
    demo.main(["--root", str(tmp_path / "in"), "--save2where", str(out),
               "--resume", str(ckpt), "--device", "cpu"])
    (lmasks, rmasks), = seen
    for img, masks in zip(pair, (lmasks, rmasks)):
        for g, w in zip(masks, jax_demo_masks(img)):
            assert np.array_equal(g[0].numpy(), w)
    with Image.open(out / "s0.png") as png:
        assert png.size == (81, 54) and np.asarray(png).dtype == np.uint16
    assert os.path.getsize(out / "s0.png") > 0
