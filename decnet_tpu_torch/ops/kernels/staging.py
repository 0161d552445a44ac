"""The card's launch limits and the Python mirror of `csrc/staging.cuh`,
shared by the launch plans of the sparse-matching kernels
(`ops/kernels/spamat.py`) and of the warp (`ops/kernels/warp.py`).

A kernel stages columns [a, e) of `rows` rows of a tensor (row r at global
element base0 + r * pitch) into shared rows of `row_stride` elements, with
column a + j of row r at r * stride + stage_lead(base0, a) + j, by 16-byte
cp.async granules (`stage_copies`), which the CPU tests check granule by
granule, since the kernels cannot run here.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Tuple

if TYPE_CHECKING:
    import torch

# The card: 132 SMs, 227 KB of shared memory a block.
SMS = 132
TARGET_BLOCKS = 2 * SMS   # rows are split until the grid has this many
SMEM_BUDGET = 100 * 1024  # a block's shared memory, so that two fit an SM
SMEM_MAX = 227 * 1024
MAX_THREADS = 256
MIN_THREADS = 128
GRAN_BYTES = 16           # one cp.async copy, one vector store
MAP_GE = GRAN_BYTES // 4  # f32 map elements a granule holds


def align16(n: int) -> int:
    return (n + 15) // 16 * 16


def aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """`t`, or a copy of it when its data does not start on 16 bytes: the
    kernels stage rows with 16-byte copies."""
    return t if t is None or t.data_ptr() % GRAN_BYTES == 0 else t.clone()


def row_stride(n: int, ge: int, pitch: int) -> int:
    """Shared elements per staged row of n columns in granules of ge
    elements, congruent to the rows' pitch modulo ge (staging.cuh)."""
    return -(-(n + 3 * ge) // ge) * ge + pitch % ge


def stage_lead(base0: int, a: int, ge: int) -> int:
    """Shared offset of column a in every staged row (staging.cuh)."""
    return ge + (base0 + a) % ge


def stage_copies(base0: int, pitch: int, n_total: int, rows: int, a: int,
                 e: int, ge: int, stride: int
                 ) -> List[Tuple[int, int, int, int]]:
    """The copies `staging::stage_rows` issues for columns [a, e) of `rows`
    rows (row r at global element base0 + r * pitch): (row, shared
    element, global element, elements), one cp.async granule when the
    count is ge and the global element granule-aligned, else the elements
    up to the row's end one by one."""
    if e <= a:
        return []
    ng = (e - a + ge - 1) // ge + 1
    lead = stage_lead(base0, a, ge)
    out = []
    for r in range(rows):
        start = base0 + r * pitch + a
        end = start + (e - a)
        for g in range(ng):
            x = (start // ge + g) * ge
            if x < end:
                out.append((r, r * stride + lead + x - start, x,
                            ge if x + ge <= n_total else end - x))
    return out
