"""Demo input/output — the port of decnet_tpu/data/io.py:65-125.

`pad_to_multiple` and `normalize_image` work on (B,3,H,W) tensors on any
device.  The PNG and calib readers run on the host for the demo CLI and
import PIL only when called."""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def pad_to_multiple(img: torch.Tensor, multiple: int = 27) -> torch.Tensor:
    """Zero-pad top and left so H and W are multiples of `multiple`."""
    h, w = img.shape[-2:]
    rh = -h % multiple
    rw = -w % multiple
    return F.pad(img, (rw, 0, rh, 0))


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB (B,3,H,W) -> ImageNet-normalised f32."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=img.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=img.device).view(1, 3, 1, 1)
    return (img.float() - mean) / std


def read_image(path: str) -> np.ndarray:
    """RGB uint8 (H,W,3)."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def read_calib_ndisp(path: str, align: int = 27) -> Optional[int]:
    """Per-scene disparity range from a Middlebury-style calib.txt (last
    line `ndisp=N`), rounded up to a multiple of `align`."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        lines = f.readlines()
    n = float(lines[-1].strip().split("=")[-1])
    return int(math.ceil(n / align) * align)


def write_submission_png(path: str, disp: np.ndarray):
    """uint16 PNG of clip(disp * 256, 0, 65535)."""
    from PIL import Image
    out = np.clip(disp * 256.0, 0, 65535).astype(np.uint16)
    Image.fromarray(out).save(path)
