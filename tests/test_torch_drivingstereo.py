"""DrivingStereo from JPEG files: the port's dataset
(decnet_tpu_torch/data/datasets.py::DrivingStereo, its images read by the
port's own decoder) against decnet_tpu's (cv2) on a tree cv2 writes here —
JPEG views at 4:2:0, uint16 disparity PNGs — sample by sample, bit for
bit, in eval mode (with gt[:130] zeroed) and in seeded train mode."""
import os

import cv2
import numpy as np
import pytest

from decnet_tpu.data import get_dataset as jax_get_dataset
from decnet_tpu_torch.data import get_dataset
from tests.test_torch_datasets import CROP, _views, assert_samples_equal

H, W = 150, 99


def write_tree(root, split, n=2, seed=0):
    rng = np.random.RandomState(seed)
    base = os.path.join(root, split)
    for d in ("left-image", "right-image", "disparity-map"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    for i in range(n):
        name = f"2018-07-{i:02d}"
        left, right, gt = _views(rng, H, W)
        for d, img in (("left-image", left), ("right-image", right)):
            cv2.imwrite(os.path.join(base, d, name + ".jpg"),
                        img.astype(np.uint8)[..., ::-1],
                        [cv2.IMWRITE_JPEG_QUALITY, 90,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
        cv2.imwrite(os.path.join(base, "disparity-map", name + ".png"),
                    (gt * 256).astype(np.uint16))


@pytest.mark.parametrize("train,mask_source", [
    (False, "compute"), (True, "compute"), (False, "wavelet")],
    ids=["eval", "train", "eval_wavelet"])
def test_jpeg_samples_equal_jax(train, mask_source, tmp_path):
    write_tree(str(tmp_path), "train")
    kw = dict(split="train", is_training=train, mask_source=mask_source,
              img_size=CROP, seed=5)
    got = get_dataset("drivingstereo", str(tmp_path), **kw)
    want = jax_get_dataset("drivingstereo", str(tmp_path), **kw)
    assert len(got) == len(want) == 2
    for rep in range(2 if train else 1):
        for i in range(len(want)):
            g, w = got[i], want[i]
            assert_samples_equal(g, w, f"{i} rep {rep}")
            if not train:
                # eval zeroes the sky rows: 130 of the image, below the
                # top-left pad to a multiple of 27
                pad = -H % 27
                assert not g["gt"][:pad + 130].any()
                assert g["gt"][pad + 130:].any()
