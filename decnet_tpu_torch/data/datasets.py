"""Dataset readers for the four benchmark suites — the port of
decnet_tpu/data/datasets.py, numpy on the host, no cv2 or PIL.

Each dataset yields a sample dict:
  left, right   (H,W,3) float32, ImageNet-normalised
  gt            (H,W)   float32 disparity (0 = invalid)
  left_masks / right_masks  [3] binary detail masks, coarsest (1/9) first
  ori_h, ori_w  ints (pre-padding size, for submission cropping)
  name          str
  n_disp        int per-scene disparity range

File formats (as the reference's loaders):
* SceneFlow  — fused .npy packs (H,W,7 = L rgb | R rgb | disparity);
               optional sibling `<split>_mask` pickles with 6 masks
               [Lfull,L3,L9, Rfull,R3,R9]; otherwise masks are computed.
* KITTI-2015 — same pack scheme, optional 8th object-mask channel;
               the `train_eval` split zeroes GT rows < 130.
* Middlebury — .pkl dicts {ndisp, im0, im1, disparity, disparity_right};
               per-scene ndisp drives max_disp.
* DrivingStereo — directory triplets left-image/right-image/disparity-map
               (/256); the views JPEG (the release's) or PNG, the
               disparities uint16 PNG.

Masks: `mask_source` "compute" (the native Gaussian-residual pipeline,
`data/masks.py`), "precomputed" (the pickles, computed where absent) or
"wavelet" (pair-consistent wavelet masks).

The dataset's one `self.rng` is shared by the loader's worker threads, as
in the JAX package: with more than one worker, which sample draws which
numbers depends on the threads' timing (ROADMAP.md section 3).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from decnet_tpu_torch.data import augment
from decnet_tpu_torch.data import io as dio
from decnet_tpu_torch.data import masks as dmasks


def _pad_topleft(arr: np.ndarray, interval: int) -> np.ndarray:
    h, w = arr.shape[:2]
    rh = (interval - h % interval) % interval
    rw = (interval - w % interval) % interval
    if rh == 0 and rw == 0:
        return arr
    pads = [(rh, 0), (rw, 0)] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, pads)


class StereoDataset:
    """Base: crop/pad, augmentation, normalisation, mask handling."""

    def __init__(self, root: str, split: str = "train", img_size=(540, 960),
                 scale: int = 3, levels: int = 3, is_training: bool = True,
                 mask_thold: float = 0.3, mask_source: str = "compute",
                 augment_cfg: Optional[dict] = None, seed: int = 0):
        self.root = root
        self.split = split
        self.img_size = img_size
        self.scale = scale
        self.levels = levels
        self.is_training = is_training
        self.mask_thold = mask_thold
        self.mask_source = mask_source
        self.augment_cfg = augment_cfg or {}
        self.interval = scale ** levels
        self.rng = np.random.RandomState(seed)
        self.default_ndisp = 192

    # -- subclass API ------------------------------------------------------
    def __len__(self):
        raise NotImplementedError

    def _load_raw(self, index: int) -> Dict:
        """Return dict(left, right, gt [0..255 floats], name, ndisp,
        optional masks6, optional gt_right)."""
        raise NotImplementedError

    # -- pipeline ----------------------------------------------------------
    def __getitem__(self, index: int) -> Dict:
        raw = self._load_raw(index)
        left, right, gt = raw["left"], raw["right"], raw["gt"]
        ori_h, ori_w = left.shape[:2]

        left = _pad_topleft(left, self.interval)
        right = _pad_topleft(right, self.interval)
        gt = _pad_topleft(gt, self.interval)
        masks6 = raw.get("masks6")
        if masks6 is not None:
            masks6 = [_pad_topleft(m, self.interval // self.scale ** (i % 3))
                      for i, m in enumerate(masks6)]

        obj_mask = raw.get("obj_mask")
        if obj_mask is not None:
            obj_mask = _pad_topleft(obj_mask, self.interval)

        if self.is_training:
            th = int(np.ceil(self.img_size[0] / self.interval) * self.interval)
            tw = int(np.ceil(self.img_size[1] / self.interval) * self.interval)
            h, w = left.shape[:2]
            if th > h or tw > w:
                # image smaller than the crop target: zero-pad at the TOP and
                # LEFT to the target (MiddleburyMask.py:178-193), masks padded
                # with the same geometry per scale (:240-254)
                ph, pw = max(th - h, 0), max(tw - w, 0)
                pad2 = lambda a, s=1: np.pad(
                    a, [(ph // s, 0), (pw // s, 0)] + [(0, 0)] * (a.ndim - 2))
                left, right, gt = pad2(left), pad2(right), pad2(gt)
                if obj_mask is not None:
                    obj_mask = pad2(obj_mask)
                if masks6 is not None:
                    masks6 = [pad2(m, self.scale ** (i % 3))
                              for i, m in enumerate(masks6)]
                h, w = left.shape[:2]
            if (th, tw) != (h, w):
                x1 = self.rng.randint(0, h - th + 1)
                y1 = self.rng.randint(0, w - tw + 1)
                # crops aligned to the pyramid (SceneflowMask.py:132-141)
                x1 = (x1 // self.interval) * self.interval
                y1 = (y1 // self.interval) * self.interval
                left = left[x1:x1 + th, y1:y1 + tw]
                right = right[x1:x1 + th, y1:y1 + tw]
                gt = gt[x1:x1 + th, y1:y1 + tw]
                if obj_mask is not None:
                    obj_mask = obj_mask[x1:x1 + th, y1:y1 + tw]
                if masks6 is not None:
                    masks6 = [m[x1 // self.scale ** (i % 3):(x1 + th) // self.scale ** (i % 3),
                                y1 // self.scale ** (i % 3):(y1 + tw) // self.scale ** (i % 3)]
                              for i, m in enumerate(masks6)]
            left, right, gt = self._augment(left, right, gt, obj_mask)

        if masks6 is not None:
            # pickle order [Lfull, L1/3, L1/9, Rfull, R1/3, R1/9] ->
            # coarsest-first lists (SceneflowMask.py:179-191)
            lmasks = [masks6[2], masks6[1], masks6[0]]
            rmasks = [masks6[5], masks6[4], masks6[3]]
        elif self.mask_source == "wavelet":
            # the paper's wavelet-based detail detection (utils/Wavelet.py,
            # shipped broken upstream) as a first-class mask family; the
            # threshold is shared across the pair for stereo consistency
            lmasks, rmasks = dmasks.wavelet_pair_masks_np(
                left / 255.0, right / 255.0, self.scale, self.levels)
        else:
            lmasks = dmasks.detail_masks_np(left / 255.0, self.scale,
                                            self.levels, self.mask_thold)
            rmasks = dmasks.detail_masks_np(right / 255.0, self.scale,
                                            self.levels, self.mask_thold)

        return {
            "left": dio.normalize_image_np(left / 255.0),
            "right": dio.normalize_image_np(right / 255.0),
            "gt": gt.astype(np.float32),
            "left_masks": [m.astype(np.float32) for m in lmasks],
            "right_masks": [m.astype(np.float32) for m in rmasks],
            "ori_h": ori_h, "ori_w": ori_w,
            "name": raw.get("name", str(index)),
            "n_disp": raw.get("ndisp", self.default_ndisp),
        }

    def _augment(self, left, right, gt, obj_mask=None):
        cfg = self.augment_cfg
        if cfg.get("glare", True) and self.rng.binomial(1, 0.5):
            left, right = augment.add_parallax_glare(left, right, self.rng)
        if cfg.get("occlusion", False) and self.rng.binomial(1, 0.3):
            right = augment.random_occlusion_patch(right, self.rng)
        if cfg.get("photometric", False):
            left, right = augment.random_photometric(left, right, self.rng)
        return left, right, gt


class SceneFlow(StereoDataset):
    def __init__(self, root, split="train", **kw):
        super().__init__(root, split, **kw)
        base = os.path.join(root, split)
        if not os.path.isdir(base):
            raise FileNotFoundError(base)
        self.files = sorted(os.path.join(base, f) for f in os.listdir(base)
                            if f.endswith(".npy"))
        self.mask_dir = base + "_mask"

    def __len__(self):
        return len(self.files)

    def _load_raw(self, index):
        pack = np.load(self.files[index]).astype(np.float32)
        name = os.path.splitext(os.path.basename(self.files[index]))[0]
        out = {"left": pack[..., 0:3], "right": pack[..., 3:6],
               "gt": pack[..., 6], "name": name, "ndisp": 192}
        mpath = os.path.join(self.mask_dir, name)
        if self.mask_source == "precomputed" and os.path.exists(mpath):
            with open(mpath, "rb") as f:
                out["masks6"] = [np.asarray(m, np.float32)
                                 for m in pickle.load(f)]
        return out


class Kitti2015(SceneFlow):
    """KITTI pack loader (KITTI15Mask.py).

    Train augs replicate the reference schedule exactly: glare applied
    TWICE with p=0.8 then p=0.5 (KITTI15Mask.py:140-145), mean-colour
    occlusion patch p=0.5 (:150-157), object-mask GT multiply p=0.3 when the
    pack carries an 8th channel (:159-162), shared photometric jitter
    (:231-244).  The `train_eval` split zeroes GT rows < 130 (:164-165)."""

    def __init__(self, root, split="train", **kw):
        kw.setdefault("augment_cfg", {"photometric": True})
        super().__init__(root, split.replace("_eval", ""), **kw)
        self.zero_top = split.endswith("_eval") or not self.is_training

    def _load_raw(self, index):
        pack = np.load(self.files[index]).astype(np.float32)
        name = os.path.splitext(os.path.basename(self.files[index]))[0]
        out = {"left": pack[..., 0:3], "right": pack[..., 3:6],
               "gt": pack[..., 6], "name": name, "ndisp": 192}
        if pack.shape[-1] == 8:          # optional object-mask channel
            out["obj_mask"] = pack[..., 7]
        mpath = os.path.join(self.mask_dir, name)
        if self.mask_source == "precomputed" and os.path.exists(mpath):
            with open(mpath, "rb") as f:
                out["masks6"] = [np.asarray(m, np.float32)
                                 for m in pickle.load(f)]
        if self.zero_top:
            out["gt"] = out["gt"].copy()
            out["gt"][:130] = 0.0
        return out

    def _augment(self, left, right, gt, obj_mask=None):
        # double glare: p=0.8 then p=0.5 (KITTI15Mask.py:140-145)
        if self.augment_cfg.get("glare", True):
            if self.rng.binomial(1, 0.8):
                left, right = augment.add_parallax_glare(left, right,
                                                         self.rng)
            if self.rng.binomial(1, 0.5):
                left, right = augment.add_parallax_glare(left, right,
                                                         self.rng)
        # mean-colour occlusion patch p=0.5 (:150-157)
        if self.augment_cfg.get("occlusion", True) \
                and self.rng.binomial(1, 0.5):
            right = augment.random_occlusion_patch(right, self.rng)
        if self.augment_cfg.get("photometric", True):
            left, right = augment.random_photometric(left, right, self.rng)
        # object-mask GT multiply p=0.3 (:159-162)
        if obj_mask is not None and self.rng.rand() < 0.3:
            gt = gt * obj_mask
        return left, right, gt


# Middlebury split zoo (MiddleburyMask.py:33-76): split name -> (processed
# dataset subdirectory, inner split directory).  eval_F is accepted even
# though the reference's elif chain would raise on it — eval.sh:6 passes
# eval_F, a latent upstream bug; the evident intent is the trainingF set.
_MIDD_SPLITS = {
    "train_Q": ("MiddEval3Q_processed", "trainingQ"),
    "eval_Q": ("MiddEval3Q_processed", "trainingQ"),
    "train_H": ("MiddEval3H_processed", "trainingH"),
    "eval_H": ("MiddEval3H_processed", "trainingH"),
    "train_F": ("MiddEval3F_processed", "trainingF"),
    "eval_F": ("MiddEval3F_processed", "trainingF"),
    "train_AG": ("", "MiddZip_raw_split_dense"),
    "train_allF": ("", "MiddZip_processed"),
    "eval_allF": ("", "MiddZip_processed"),
    "train_allF_EL": ("", "MiddZip_processed_EL"),
    "eval_allF_EL": ("", "MiddZip_processed_EL"),
    "train_merge": ("", "MiddMerged"),
    "test_Q": ("MiddEval3Q_processed", "testQ"),
    "test_H": ("MiddEval3H_processed", "testH"),
    "test_F": ("MiddEval3F_processed", "testF"),
}


def _midd_quality_filter(names: Sequence[str]) -> List[str]:
    """Training file filter (MiddleburyMask.py:81-90): keep files whose
    name-suffix score (text after the last '-') parses as a float > 0.88;
    non-numeric suffixes are kept unless the name contains 'perfect'."""
    out = []
    for name in names:
        stem = os.path.basename(name).replace(".pkl", "")
        try:
            if float(stem.split("-")[-1]) > 0.88:
                out.append(name)
        except ValueError:
            if "perfect" not in stem:
                out.append(name)
    return out


class Middlebury(StereoDataset):
    """Middlebury .pkl loader with the reference split zoo, the training
    quality filter, per-scene ndisp and flip-with-right-disparity aug
    (MiddleburyMask.py)."""

    def __init__(self, root, split="eval_F", **kw):
        kw.setdefault("is_training", split.startswith("train"))
        super().__init__(root, split, **kw)
        base = os.path.join(root, split)       # direct-directory layout
        if split in _MIDD_SPLITS and not os.path.isdir(base):
            sub, inner = _MIDD_SPLITS[split]   # reference layout
            base = os.path.join(root, sub, inner) if sub \
                else os.path.join(root, inner)
        if not os.path.isdir(base):
            raise FileNotFoundError(base)
        files = sorted(f for f in os.listdir(base) if f.endswith(".pkl"))
        if self.is_training:
            files = _midd_quality_filter(files)
        self.files = [os.path.join(base, f) for f in files]

    def __len__(self):
        return len(self.files)

    def _load_raw(self, index):
        with open(self.files[index], "rb") as f:
            d = pickle.load(f)
        name = os.path.splitext(os.path.basename(self.files[index]))[0]
        left = np.asarray(d["im0"], np.float32)
        right = np.asarray(d["im1"], np.float32)
        gt = np.nan_to_num(np.asarray(d["disparity"], np.float32),
                           posinf=0.0, neginf=0.0)
        out = {"left": left, "right": right, "gt": gt, "name": name,
               "ndisp": int(d.get("ndisp", 192))}
        masks6 = None
        if self.mask_source == "precomputed":
            mdir = os.path.dirname(self.files[index]) + "_mask"
            mpath = os.path.join(mdir, name)
            if os.path.exists(mpath):
                with open(mpath, "rb") as f:
                    masks6 = [np.asarray(m, np.float32)
                              for m in pickle.load(f)]
        if self.is_training and "disparity_right" in d \
                and self.rng.binomial(1, 0.5):
            gr = np.nan_to_num(np.asarray(d["disparity_right"], np.float32),
                               posinf=0.0, neginf=0.0)
            l, r, g = augment.horizontal_flip_stereo(left, right, gt, gr)
            out.update(left=l, right=r, gt=g)
            if masks6 is not None:
                # flip swaps L<->R masks, each mirrored (MiddleburyMask.py:
                # 225-233); pickle order [Lfull,L3,L9, Rfull,R3,R9]
                masks6 = ([np.ascontiguousarray(m[:, ::-1])
                           for m in masks6[3:6]]
                          + [np.ascontiguousarray(m[:, ::-1])
                             for m in masks6[0:3]])
        if masks6 is not None:
            out["masks6"] = masks6
        return out


class DrivingStereo(StereoDataset):
    """Raw directory triplets (DrivingStereoMask.py:90-96): JPEG or PNG
    views, uint16 disparity PNGs; eval zeroes gt[:130]."""

    def __init__(self, root, split="train", **kw):
        super().__init__(root, split, **kw)
        base = os.path.join(root, split)
        ldir = os.path.join(base, "left-image")
        self.left_files = sorted(
            os.path.join(ldir, f) for f in os.listdir(ldir))
        self.rdir = os.path.join(base, "right-image")
        self.ddir = os.path.join(base, "disparity-map")

    def __len__(self):
        return len(self.left_files)

    def _load_raw(self, index):
        lp = self.left_files[index]
        stem = os.path.splitext(os.path.basename(lp))[0]
        left = dio.read_image(lp).astype(np.float32)
        rp = os.path.join(self.rdir, os.path.basename(lp))
        right = dio.read_image(rp).astype(np.float32)
        dp = os.path.join(self.ddir, stem + ".png")
        gt = dio.read_disparity_png(dp)
        if not self.is_training:
            gt = gt.copy()
            gt[:130] = 0.0  # DrivingStereoMask.py:152-153
        return {"left": left, "right": right, "gt": gt, "name": stem,
                "ndisp": 192}


_DATASETS = {
    "sceneflow": SceneFlow, "sceneflowmask": SceneFlow,
    "kitti15": Kitti2015, "kitti15mask": Kitti2015,
    "middlebury": Middlebury, "middleburymask": Middlebury,
    "drivingstereo": DrivingStereo, "drivingstereomask": DrivingStereo,
}


def get_dataset(name: str, root: str, **kw) -> StereoDataset:
    key = name.lower()
    if key not in _DATASETS:
        raise KeyError(f"dataset {name} unknown; have {sorted(_DATASETS)}")
    return _DATASETS[key](root, **kw)
