"""Launch plans of the moments, dRef and dTar kernels
(`ops/kernels/spamat.py`) and of the warp (`ops/kernels/warp.py`), on the
CPU: the kernels cannot run here, so the geometry they are given is checked
in Python.

For every fine-stage shape of a served 540x972 request and of a training
batch, for training batches too small to fill the card (rows split into
segments), and for ragged widths (W = 1, W < D, W not a multiple of the tile),
in bf16 and f32:
  * the tiling visits every (active query, candidate key) pair of the band
    exactly once: each owned column lies in one block, and every partner of
    its band lies in that block's staged window; the warp's blocks cover
    every output channel of every row once;
  * the grid, threads and shared memory are launchable (<= 227 KB);
  * `stage_copies`, the mirror of the kernels' cp.async staging
    (csrc/staging.cuh), puts each needed element of each staged row in its
    slot, copies whole granules only from granule-aligned global elements
    to granule-aligned shared elements, and keeps the rows apart."""
import numpy as np
import pytest

from decnet_tpu_torch.ops.kernels import spamat, staging
from decnet_tpu_torch.ops.kernels import warp as kwarp

STAGES = [(1, 72, 60, 108, 24), (1, 24, 180, 324, 72), (1, 8, 540, 972, 216),
          (8, 72, 18, 54, 24), (8, 24, 54, 162, 72), (8, 8, 162, 486, 216)]
RAGGED = [(1, 3, 3, 1, 4), (2, 5, 3, 7, 24), (1, 8, 1, 1000, 216),
          (3, 9, 5, 77, 16), (1, 130, 2, 300, 40)]
# training stages 2 and 3 at B = 2 and 1: too few rows, so split rows
SPLIT_ROWS = [(2, 24, 54, 162, 72), (1, 8, 162, 486, 216)]
SHAPES = STAGES + SPLIT_ROWS + RAGGED
PLANS = {"moments": spamat.moments_plan, "dtar": spamat.dtar_plan,
         "dref": spamat.dref_plan}
# (B, C, H, W) of the warp: the stage shapes, and ragged sizes (H = 2, W
# below a granule, C wider than a block's share, rows that fill the card)
WARP_SHAPES = ([(B, C, H, W) for B, C, H, W, _ in STAGES]
               + [(1, 3, 2, 2), (2, 5, 3, 7), (1, 1, 2, 1000), (3, 9, 5, 77),
                  (1, 130, 2, 300), (4, 16, 100, 33)])


def blocks(plan, W, D, kind):
    """(owned columns, staged window) of each block of one row."""
    for s in range(plan.segs):
        a, b = s * plan.tile, min((s + 1) * plan.tile, W)
        if kind in ("moments", "dref"):
            yield (a, b), (max(0, a - D + 1), b)
        else:
            yield (a, b), (a, min(b + D - 1, W))


@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("B,C,H,W,D", SHAPES)
def test_plan_covers_the_band_once(B, C, H, W, D, esize, kind):
    if kind == "dref" and C > spamat.MAX_DREF_CHANNELS:
        with pytest.raises(ValueError):     # one instance per C <= 8, 24, 72
            spamat.dref_plan(B, C, H, W, D, esize)
        return
    plan = PLANS[kind](B, C, H, W, D, esize)
    assert plan.segs * plan.tile >= W > (plan.segs - 1) * plan.tile
    assert plan.span == min(plan.tile + D - 1, W)
    assert 32 <= plan.threads <= staging.MAX_THREADS
    assert plan.threads % 32 == 0 and plan.threads % plan.lanes == 0
    assert plan.smem <= staging.SMEM_MAX
    owner = np.full(W, -1)
    for i, ((a, b), (wa, wb)) in enumerate(blocks(plan, W, D, kind)):
        assert b - a <= plan.tile and wb - wa <= plan.span
        assert (owner[a:b] == -1).all()
        owner[a:b] = i
        for col in range(a, b):
            # the band's partners: keys col-D+1..col of a query, queries
            # col..col+D-1 of a key
            lo, hi = ((max(0, col - D + 1), col + 1)
                      if kind in ("moments", "dref")
                      else (col, min(col + D, W)))
            assert wa <= lo and hi <= wb, (col, lo, hi, wa, wb)
    assert (owner >= 0).all()


@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("B,C,H,W,D", SHAPES)
def test_staged_rows_are_aligned_and_complete(B, C, H, W, D, esize, kind):
    if kind == "dref" and C > spamat.MAX_DREF_CHANNELS:
        C = spamat.MAX_DREF_CHANNELS
    plan = PLANS[kind](B, C, H, W, D, esize)
    ge = staging.GRAN_BYTES // esize
    hw = H * W
    n_total = B * C * hw
    rows = {(0, 0), (B - 1, H - 1), (0, min(1, H - 1)),
            (B // 2, min(2, H - 1))}
    for b, h in sorted(rows):
        base0 = b * C * hw + h * W
        for (a, e), (wa, we) in blocks(plan, W, D, kind):
            for lo, hi, n in ((a, e, plan.tile), (wa, we, plan.span)):
                stride = staging.row_stride(n, ge, hw)
                lead = staging.stage_lead(base0, lo, ge)
                filled = {}
                for r, sh, x, count in staging.stage_copies(
                        base0, hw, n_total, C, lo, hi, ge, stride):
                    if count == ge:
                        assert sh % ge == 0 and x % ge == 0, (sh, x)
                    else:                  # the tensor's end, one by one
                        assert x + ge > n_total
                    # a row's copies stay inside its own stride
                    assert r * stride <= sh and sh + count <= (r + 1) * stride
                    for i in range(count):
                        assert filled.setdefault(sh + i, x + i) == x + i
                for r in range(C):
                    for col in range(lo, hi):
                        slot = r * stride + lead + (col - lo)
                        assert filled.get(slot) == base0 + r * hw + col


def test_lanes():
    """Candidate lanes near D / 32; dTar's chunk lanes cover C in 8s, and
    a key's lanes never exceed a warp."""
    assert [spamat.candidate_lanes(d) for d in (1, 24, 32, 33, 72, 216,
                                                 2000)] == [1, 1, 1, 2, 4,
                                                            8, 32]
    assert [spamat.dtar_lanes(c, 216) for c in (1, 8, 9, 24, 72, 256)] == [
        8, 8, 16, 32, 32, 32]
    assert [spamat.dtar_lanes(c, 24) for c in (8, 24, 72)] == [1, 4, 16]
    with pytest.raises(ValueError):
        spamat.dtar_lanes(257, 24)
    # dRef: the chunk lanes of C's instance (C <= 8, 24, 72)
    assert [spamat.dref_lanes(c, 216) for c in (1, 8, 9, 16, 24, 25, 72)] == [
        8, 8, 32, 32, 32, 32, 32]
    assert [spamat.dref_lanes(c, 24) for c in (8, 24, 72)] == [1, 4, 16]
    assert [spamat.dref_lanes(c, 72) for c in (8, 24, 72)] == [4, 16, 32]
    with pytest.raises(ValueError):
        spamat.dref_lanes(73, 24)


def test_plans_at_the_model_shapes():
    """Whole rows where the rows fill the card; split rows where they do
    not; 16-byte granules hold 8 bf16 values."""
    serve1 = spamat.moments_plan(1, 72, 60, 108, 24, 2)
    assert serve1.segs == 3 and serve1.tile == 36 and serve1.threads == 128
    train3 = spamat.moments_plan(8, 8, 162, 486, 216, 2)
    assert (train3.segs, train3.tile, train3.span) == (1, 486, 486)
    assert spamat.dtar_plan(8, 72, 18, 54, 24, 2).lanes == 16
    for stage in ((8, 72, 18, 54, 24), (8, 24, 54, 162, 72),
                  (8, 8, 162, 486, 216)):     # training: whole rows
        dref = spamat.dref_plan(*stage, 2)
        assert (dref.segs, dref.tile, dref.threads) == (1, stage[3], 256)
    for shape, segs in zip(SPLIT_ROWS, (3, 2)):  # chip_smoke.py's cases
        for plan in (spamat.dref_plan, spamat.dtar_plan):
            assert plan(*shape, 2).segs == plan(*shape, 4).segs == segs
    assert [spamat.dref_plan(*s, 2).lanes for s in (
        (8, 72, 18, 54, 24), (8, 24, 54, 162, 72),
        (8, 8, 162, 486, 216))] == [16, 16, 8]
    assert spamat.moments_plan(1, 8, 540, 972, 216, 2).lanes == 8
    assert staging.row_stride(486, 8, 162 * 486) % 8 == (162 * 486) % 8


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("B,C,H,W", WARP_SHAPES)
def test_warp_plan_covers_every_output_once(B, C, H, W, esize):
    """The warp's blocks: channel groups that cover C once, launchable, and
    the source rows y0 and y0 + 1 and the disparity row of each output row
    staged whole and aligned."""
    plan = kwarp.warp_plan(B, C, H, W, esize)
    assert plan.groups * plan.cg >= C > (plan.groups - 1) * plan.cg
    assert B * H * plan.groups >= min(staging.TARGET_BLOCKS, B * H * C)
    assert 32 <= plan.threads <= staging.MAX_THREADS
    assert plan.threads % 32 == 0
    assert plan.smem <= staging.SMEM_MAX
    ge = staging.GRAN_BYTES // esize
    hw = H * W
    stride = staging.row_stride(W, ge, hw)
    assert plan.smem == (2 * staging.align16(esize * plan.cg * stride)
                         + staging.align16(4 * staging.row_stride(
                             W, staging.MAP_GE, 0)))
    n_total = B * C * hw
    sy = np.float32(H / (H - 1.0))
    for b, h in sorted({(0, 0), (B - 1, H - 1), (B // 2, H // 2)}):
        y0 = int(np.floor(np.float32(h) * sy - np.float32(0.5)))
        assert -1 <= y0 <= H - 1
        seen = set()
        for g in range(plan.groups):
            c0 = g * plan.cg
            nc = min(plan.cg, C - c0)
            for yr in (y0, y0 + 1):
                if not 0 <= yr < H:             # zero taps, not staged
                    continue
                base0 = (b * C + c0) * hw + yr * W
                lead = staging.stage_lead(base0, 0, ge)
                filled = {}
                for r, sh, x, count in staging.stage_copies(
                        base0, hw, n_total, nc, 0, W, ge, stride):
                    if count == ge:
                        assert sh % ge == 0 and x % ge == 0
                    else:
                        assert x + ge > n_total
                    assert r * stride <= sh and sh + count <= (r + 1) * stride
                    for i in range(count):
                        assert filled.setdefault(sh + i, x + i) == x + i
                for r in range(nc):
                    for col in range(W):
                        assert (filled[r * stride + lead + col]
                                == base0 + r * hw + col)
            dbase = (b * H + h) * W         # the disparity row, staged
            dstride = staging.row_stride(W, staging.MAP_GE, 0)
            dlead = staging.stage_lead(dbase, 0, staging.MAP_GE)
            dfill = {}
            for r, sh, x, count in staging.stage_copies(
                    dbase, 0, B * H * W, 1, 0, W, staging.MAP_GE, dstride):
                assert r == 0 and sh + count <= dstride
                if count == staging.MAP_GE:
                    assert sh % count == 0 and x % count == 0
                for i in range(count):
                    dfill[sh + i] = x + i
            assert all(dfill[dlead + w] == dbase + w for w in range(W))
            # each thread stores its columns of the block's channels
            got = {(b * C + c0 + c) * hw + h * W + w
                   for c in range(nc) for w in range(W)}
            assert not got & seen
            seen |= got
        assert seen == {(b * C + c) * hw + h * W + w
                        for c in range(C) for w in range(W)}


def test_warp_plans_at_the_model_shapes():
    """Channels split where the rows leave fewer than two blocks per SM:
    serving stages 1 and 2 and training stage 1; whole rows elsewhere."""
    got = [(kwarp.warp_plan(B, C, H, W, 2).groups,
            kwarp.warp_plan(B, C, H, W, 2).cg)
           for B, C, H, W, _ in STAGES]
    assert got == [(5, 15), (2, 12), (1, 8), (2, 36), (1, 24), (1, 8)]


def suite_stages(B, H, W, D):
    """(B, C, H, W, D) of the three fine stages of a padded H x W input."""
    return [(B, 72, H // 9, W // 9, D // 9), (B, 24, H // 3, W // 3, D // 3),
            (B, 8, H, W, D)]


# the benchmark suites' shapes: KITTI served (375x1242 padded to
# 378x1242, max_disp 216) and its training crop (B = 8 of 270x513),
# Middlebury-H (999x1485, ndisp 289 bucketed to 297) and Middlebury-F
# (1998x2970, 810)
SUITES = {"kitti": suite_stages(1, 378, 1242, 216),
          "kitti_train": suite_stages(8, 270, 513, 216),
          "middlebury_h": suite_stages(1, 999, 1485, 297),
          "middlebury_f": suite_stages(1, 1998, 2970, 810)}


@pytest.mark.parametrize("suite", SUITES)
def test_plans_at_the_suites_shapes(suite):
    """Every kernel has a launch plan at the suites' shapes that covers
    each row once within the shared memory; the forward moments split
    rows into segments at Middlebury-H's stage 3 and at KITTI's stage 1
    (B = 1)."""
    for B, C, H, W, D in SUITES[suite]:
        for kind, plan_fn in PLANS.items():
            for esize in (2, 4):
                plan = plan_fn(B, C, H, W, D, esize)
                assert plan.segs * plan.tile >= W > (plan.segs - 1) * plan.tile
                assert plan.smem <= spamat.SMEM_MAX
        wp = kwarp.warp_plan(B, C, H, W, 2)
        assert wp.groups * wp.cg >= C > (wp.groups - 1) * wp.cg
    stage3 = {k: spamat.moments_plan(*v[2], 2) for k, v in SUITES.items()}
    assert (stage3["middlebury_h"].segs, stage3["middlebury_h"].tile) == \
        (2, 743)
    assert spamat.moments_plan(*SUITES["kitti"][0], 2).segs == 4
    assert spamat.dtar_plan(*SUITES["kitti"][2], 2).tile == 621
    assert [spamat.candidate_lanes(d) for d in (33, 99, 297, 810)] == \
        [2, 4, 16, 32]
