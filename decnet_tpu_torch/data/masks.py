"""Host detail masks of the demo — the port of
decnet_tpu/data/masks.py::detail_masks_np as the JAX demo runs it
(decnet_tpu/cli/demo.py:96-105), through the native library.

The Gaussian-pyramid residual masks come from
`native/decnet_native.cc::decnet_detail_masks` (the reference's
`detailDetection`: per level blur, downsample, upsample, blur, sum
|residual| over RGB, min-max normalise, threshold), bound here by ctypes on
its own.  `ops/kernels/build.py` compiles that source with g++ into the
build directory at first use; a failed build raises.  The training stream
computes its masks on the device instead (`ops/detail.py`), as the JAX
package's does."""
from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from decnet_tpu_torch.ops.kernels import build

_PF = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "decnet_detail_masks": [_PF, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_float,
                            ctypes.POINTER(_PF)],
    "decnet_detail_masks_batch": [_PF, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_float,
                                  ctypes.POINTER(_PF), ctypes.c_int]}


def detail_masks_np(img: np.ndarray, scale: int = 3, levels: int = 3,
                    thold: float = 0.3) -> List[np.ndarray]:
    """Binary f32 masks of img (H,W,C) float in [0,1] (H and W divisible
    by scale**levels, as the demo pads them); coarsest first
    ([1/scale^(levels-1), ..., full]), the model's mask order."""
    return detail_masks_batch(np.asarray(img)[None], scale, levels,
                              thold)[0]


def detail_masks_batch(imgs: np.ndarray, scale: int = 3, levels: int = 3,
                       thold: float = 0.3) -> List[List[np.ndarray]]:
    """`detail_masks_np` of each image of imgs (N,H,W,C), one host thread
    per image (up to the host's cores); per image coarsest first."""
    imgs = np.ascontiguousarray(imgs, np.float32)
    if imgs.ndim != 4:
        raise ValueError(f"imgs must be (N,H,W,C), got {imgs.shape}")
    N, H, W, C = imgs.shape
    lib = build.load(build.HOST_LIB, _SIGNATURES, restype=None)
    outs = [[np.empty((H // scale ** i, W // scale ** i), np.float32)
             for i in range(levels)] for _ in range(N)]
    ptrs = (_PF * (N * levels))(*[o.ctypes.data_as(_PF)
                                  for per in outs for o in per])
    lib.decnet_detail_masks_batch(imgs.ctypes.data_as(_PF), N, H, W, C,
                                  scale, levels, ctypes.c_float(thold), ptrs,
                                  0)
    return [per[::-1] for per in outs]
