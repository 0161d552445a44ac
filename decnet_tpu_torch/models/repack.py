"""Geometry of the space-to-depth ("packed") convolutions — the port of
decnet_tpu/models/repack.py:46-53 (`packed_geometry`), which the s2d model
needs to build RefinementS2D's schedule.  The weight-repacking functions
of that module are not ported."""
from __future__ import annotations

from typing import Tuple


def packed_geometry(d: int, r: int) -> Tuple[int, int]:
    """(packed kernel extent E, packed dilation pd) of a full-res 3-tap
    conv with dilation d over the r-packed grid: taps at {-d, 0, d} land on
    packed offsets {-ceil(d/r)..ceil(d/r)}; when d is a multiple of r they
    stay phase-diagonal and compress to a 3-tap conv with dilation d/r."""
    if d > 1 and d % r == 0:
        return 3, d // r
    return 2 * ((d + r - 1) // r) + 1, 1
