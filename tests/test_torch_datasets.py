"""The port's datasets (decnet_tpu_torch/data/datasets.py, synthetic.py)
against decnet_tpu's on the same fixture files, written here by numpy, cv2
and pickle as tests/test_train_and_data.py and tests/test_drivingstereo.py
write theirs (DrivingStereo with PNG images here; its JPEG files in
tests/test_torch_drivingstereo.py).

Every sample must equal JAX's key by key, bit for bit: eval mode, and
seeded train mode (crops, augmentations, KITTI's object-mask draw,
Middlebury's flip with the right disparity), for each mask source the
suite has.  The samples are drawn in order from one dataset object, so the
shared `self.rng` advances as with one loader worker."""
import os
import pickle

import cv2
import numpy as np
import pytest

from decnet_tpu.data import get_dataset as jax_get_dataset
from decnet_tpu_torch.data import get_dataset

# fixture images: 63x99 (padded to 81x108 by the datasets), crops 27x54
H, W = 63, 99
CROP = (27, 54)


def _views(rng, h=H, w=W):
    """Two textured [0,255] views (the right shifted by ~8 px) and a
    disparity map in [1, 40]."""
    left = np.round(rng.rand(h, w, 3) * 255).astype(np.float32)
    right = np.roll(left, -8, axis=1) + rng.rand(h, w, 3).astype(
        np.float32) * 4
    gt = (1 + rng.rand(h, w) * 39).astype(np.float32)
    return left, np.clip(right, 0, 255), gt


def _masks6(rng, h=H, w=W):
    """The reference's precomputed masks [Lfull, L3, L9, Rfull, R3, R9]."""
    return [(rng.rand(h // s, w // s) < 0.3).astype(np.float32)
            for _ in range(2) for s in (1, 3, 9)]


def write_packs(root, split, n=3, seed=0, obj_mask=False, masks=True):
    """SceneFlow / KITTI packs (H,W,7|8) and `<split>_mask` pickles."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, split), exist_ok=True)
    os.makedirs(os.path.join(root, split + "_mask"), exist_ok=True)
    for i in range(n):
        left, right, gt = _views(rng)
        chans = [left, right, gt[..., None]]
        if obj_mask and i % 2 == 0:
            chans.append((rng.rand(H, W, 1) < 0.7).astype(np.float32))
        np.save(os.path.join(root, split, f"{i:04d}.npy"),
                np.concatenate(chans, axis=-1))
        if masks and i != 1:          # one scene without its pickle
            with open(os.path.join(root, split + "_mask", f"{i:04d}"),
                      "wb") as f:
                pickle.dump(_masks6(rng), f)


def write_middlebury(root, seed=0, ndisps=(64, 100, 150)):
    """Middlebury pickles in the reference layout (MiddEval3H_processed/
    trainingH, with `_mask` pickles); quality-suffixed names, one of them
    'perfect' (dropped in training), one scene smaller than the crop."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "MiddEval3H_processed", "trainingH")
    os.makedirs(base, exist_ok=True)
    os.makedirs(base + "_mask", exist_ok=True)
    names = ["Adirondack-0.95", "Jadeplant-perfect", "Motorcycle-0.91"]
    for i, (name, nd) in enumerate(zip(names, ndisps)):
        h, w = (18, 45) if i == 2 else (H, W)
        left, right, gt = _views(rng, h, w)
        gt[0, :5] = np.inf
        d = {"ndisp": nd, "im0": left, "im1": right, "disparity": gt,
             "disparity_right": np.roll(gt, 3, axis=1)}
        with open(os.path.join(base, name + ".pkl"), "wb") as f:
            pickle.dump(d, f)
        with open(os.path.join(base + "_mask", name), "wb") as f:
            pickle.dump(_masks6(rng, h, w), f)
    return names


def write_drivingstereo(root, split="train", n=2, seed=0):
    """DrivingStereo triplets: 8-bit RGB PNG views, uint16 disparity PNG
    (value / 256), written by cv2."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, split)
    for d in ("left-image", "right-image", "disparity-map"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    for i in range(n):
        name = f"2018-07-{i:02d}"
        left, right, gt = _views(rng, 140, W)
        for d, img in (("left-image", left), ("right-image", right)):
            cv2.imwrite(os.path.join(base, d, name + ".png"),
                        img.astype(np.uint8)[..., ::-1])
        cv2.imwrite(os.path.join(base, "disparity-map", name + ".png"),
                    (gt * 256).astype(np.uint16))


def make_suite(suite, root):
    """(dataset name, split for eval, split for train) of a fixture."""
    root = str(root)
    if suite == "sceneflow":
        write_packs(root, "train")
        return "sceneflow", "train", "train"
    if suite == "kitti15":
        write_packs(root, "train", obj_mask=True)
        return "kitti15", "train_eval", "train"
    if suite == "middlebury":
        write_middlebury(root)
        return "middlebury", "eval_H", "train_H"
    write_drivingstereo(root)
    return "drivingstereo", "train", "train"


def assert_samples_equal(got, want, where=""):
    assert set(got) == set(want), where
    for k, w in want.items():
        g = got[k]
        if isinstance(w, list):
            assert len(g) == len(w), (where, k)
            for i, (a, b) in enumerate(zip(g, w)):
                assert np.array_equal(a, b) and np.asarray(a).dtype == \
                    np.asarray(b).dtype, (where, k, i)
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), (where, k)
        else:
            assert g == w, (where, k)


# (suite, mask sources it has): DrivingStereo ships no mask pickles
CASES = [(s, m) for s in ("sceneflow", "kitti15", "middlebury")
         for m in ("compute", "precomputed", "wavelet")] + \
        [("drivingstereo", m) for m in ("compute", "wavelet")]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("suite,mask_source", CASES)
def test_samples_equal_jax(suite, mask_source, train, tmp_path):
    name, eval_split, train_split = make_suite(suite, tmp_path)
    kw = dict(split=train_split if train else eval_split, is_training=train,
              mask_source=mask_source, img_size=CROP, seed=5)
    got = get_dataset(name, str(tmp_path), **kw)
    want = jax_get_dataset(name, str(tmp_path), **kw)
    assert len(got) == len(want) > 0
    # two passes in train mode: the shared rng's draws go on
    for rep in range(2 if train else 1):
        for i in range(len(want)):
            assert_samples_equal(got[i], want[i], f"{suite} {i} rep {rep}")


def test_middlebury_flip_and_kitti_object_mask_drawn(tmp_path):
    """The seeded train samples above really take the augmentations'
    branches: Middlebury's flip swaps the views, KITTI multiplies the
    ground truth by the object mask."""
    make_suite("middlebury", tmp_path / "m")
    ds = get_dataset("middlebury", str(tmp_path / "m"), split="train_H",
                     is_training=True, img_size=CROP, seed=5)
    with open(ds.files[0], "rb") as f:
        im0 = pickle.load(f)["im0"]
    flipped = [not np.array_equal(ds._load_raw(0)["left"], im0)
               for _ in range(12)]
    assert any(flipped) and not all(flipped)
    make_suite("kitti15", tmp_path / "k")
    ds = get_dataset("kitti15", str(tmp_path / "k"), split="train",
                     is_training=True, img_size=CROP, seed=5)
    zeroed = [np.mean(ds[0]["gt"] == 0) for _ in range(12)]
    assert min(zeroed) < max(zeroed)


def test_host_synthetic_equals_jax():
    kw = dict(split="train", is_training=True, img_size=(27, 54), seed=3,
              length=3)
    got = get_dataset("synthetic", "", **kw)
    want = jax_get_dataset("synthetic", "", **kw)
    for i in range(3):
        assert_samples_equal(got[i], want[i], f"synthetic {i}")


def test_host_masks_equal_jax():
    """The masks no dataset case above reaches alone: the per-image wavelet
    masks, the anisotropic pre-filter and `stereo_pair_masks`; and the
    wavelet masks' nearest resampling against cv2.resize(INTER_NEAREST),
    which the JAX package calls, at every grid pair the datasets' and the
    demo's sizes give (wavelet grid H/2^i onto stage grid H/3^i)."""
    from decnet_tpu.data import masks as jmasks
    from decnet_tpu_torch.data import masks as tmasks
    rng = np.random.RandomState(6)
    for h, w in ((27, 54), (54, 81), (81, 108), (108, 243)):
        left, right = (rng.rand(h, w, 3).astype(np.float32)
                       for _ in range(2))
        for got, want in (
                (tmasks.wavelet_detail_masks_np(left),
                 jmasks.wavelet_detail_masks_np(left)),
                (tmasks.detail_masks_np(left, diffusion_iters=3),
                 jmasks.detail_masks_np(left, diffusion_iters=3)),
                (sum(tmasks.stereo_pair_masks(left, right), []),
                 sum(jmasks.stereo_pair_masks(left, right), []))):
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b), (h, w)
        np.testing.assert_array_equal(
            tmasks.anisotropic_diffusion(left, 4),
            jmasks.anisotropic_diffusion(left, 4))
    sizes = {27, 54, 63, 81, 99, 108, 140, 243, 375, 378, 540, 960, 972,
             999, 1242, 1485, 1998, 2970}
    m = rng.rand(8, 8).astype(np.float32)
    for n in sizes:
        for lev in (1, 2, 3):
            src, dst = -(-n // 2 ** lev), n // 3 ** (lev - 1)
            a = np.repeat(m, -(-src // 8), 0)[:src]
            assert np.array_equal(
                tmasks._to_stage_grid(a, dst, 8),
                cv2.resize(a, (8, dst), interpolation=cv2.INTER_NEAREST)), \
                (n, lev)
