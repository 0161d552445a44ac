"""Seeded synthetic stereo requests for smoke runs and profiles.

Not the JAX package's training stream (decnet_tpu/data/device_synth.py);
it borrows that stream's texture gains so that the faithful checkpoint sees
images of the kind it was trained on."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def synthetic_pair(H: int, W: int, gen: torch.Generator, device="cuda"
                   ) -> Tuple[torch.Tensor, ...]:
    """A random-texture right image and a left image warped from it by a
    piecewise-constant disparity field in [8, 180]: a fronto-parallel
    background plane and four nearer rectangles.

    Returns (left, right) (1,3,H,W) in [0,1], the left view's disparity
    (1,H,W) and the mask of left pixels whose match lies inside the right
    image.  `gen` is a torch.Generator on `device`."""
    # coarse colour, mid detail and pixel noise, with the gains of the
    # checkpoint's training stream
    tex = torch.zeros(1, 3, H, W, device=device)
    for cells, gain in ((6, 120.0), (25, 80.0), (2 * W, 130.0)):
        noise = torch.rand(1, 3, min(cells, 2 * H), cells, generator=gen,
                           device=device)
        tex += gain / 255.0 * F.interpolate(noise, size=(H, W),
                                            mode="bilinear",
                                            align_corners=False)

    def uniform(lo, hi):
        u = float(torch.rand(1, generator=gen, device=device))
        return lo + (hi - lo) * u

    disp = torch.full((1, H, W), float(round(uniform(8, 60))), device=device)
    for _ in range(4):
        h, w = int(uniform(H / 8, H / 3)), int(uniform(W / 8, W / 3))
        y, x = int(uniform(0, H - h)), int(uniform(0, W - w))
        disp[:, y:y + h, x:x + w] = float(round(uniform(60, 180)))
    src = torch.arange(W, device=device).view(1, 1, W) - disp.long()
    valid = src >= 0
    idx = src.clamp(min=0)[:, None].expand(1, 3, H, W)
    left = torch.gather(tex, 3, idx)
    return left.clamp(0, 1), tex.clamp(0, 1), disp, valid
