"""Launch plans of the moments and dTar kernels (`ops/kernels/spamat.py`),
on the CPU: the kernels cannot run here, so the geometry they are given is
checked in Python.

For every fine-stage shape of a served 540x972 request and of a training
batch, and for ragged widths (W = 1, W < D, W not a multiple of the tile),
in bf16 and f32:
  * the tiling visits every (active query, candidate key) pair of the band
    exactly once: each owned column lies in one block, and every partner of
    its band lies in that block's staged window;
  * the grid, threads and shared memory are launchable (<= 227 KB);
  * `stage_copies`, the mirror of the kernels' cp.async staging
    (csrc/staging.cuh), puts each needed element of each staged row in its
    slot, copies whole granules only from granule-aligned global elements
    to granule-aligned shared elements, and keeps the rows apart."""
import numpy as np
import pytest

from decnet_tpu_torch.ops.kernels import spamat

STAGES = [(1, 72, 60, 108, 24), (1, 24, 180, 324, 72), (1, 8, 540, 972, 216),
          (8, 72, 18, 54, 24), (8, 24, 54, 162, 72), (8, 8, 162, 486, 216)]
RAGGED = [(1, 3, 3, 1, 4), (2, 5, 3, 7, 24), (1, 8, 1, 1000, 216),
          (3, 9, 5, 77, 16), (1, 130, 2, 300, 40)]
SHAPES = STAGES + RAGGED
PLANS = {"moments": spamat.moments_plan, "dtar": spamat.dtar_plan}


def blocks(plan, W, D, kind):
    """(owned columns, staged window) of each block of one row."""
    for s in range(plan.segs):
        a, b = s * plan.tile, min((s + 1) * plan.tile, W)
        if kind == "moments":
            yield (a, b), (max(0, a - D + 1), b)
        else:
            yield (a, b), (a, min(b + D - 1, W))


@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("B,C,H,W,D", SHAPES)
def test_plan_covers_the_band_once(B, C, H, W, D, esize, kind):
    plan = PLANS[kind](B, C, H, W, D, esize)
    assert plan.segs * plan.tile >= W > (plan.segs - 1) * plan.tile
    assert plan.span == min(plan.tile + D - 1, W)
    assert 32 <= plan.threads <= spamat.MAX_THREADS
    assert plan.threads % 32 == 0 and plan.threads % plan.lanes == 0
    assert plan.smem <= spamat.SMEM_MAX
    owner = np.full(W, -1)
    for i, ((a, b), (wa, wb)) in enumerate(blocks(plan, W, D, kind)):
        assert b - a <= plan.tile and wb - wa <= plan.span
        assert (owner[a:b] == -1).all()
        owner[a:b] = i
        for col in range(a, b):
            # the band's partners: keys col-D+1..col of a query, queries
            # col..col+D-1 of a key
            lo, hi = ((max(0, col - D + 1), col + 1) if kind == "moments"
                      else (col, min(col + D, W)))
            assert wa <= lo and hi <= wb, (col, lo, hi, wa, wb)
    assert (owner >= 0).all()


@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("B,C,H,W,D", SHAPES)
def test_staged_rows_are_aligned_and_complete(B, C, H, W, D, esize, kind):
    plan = PLANS[kind](B, C, H, W, D, esize)
    ge = spamat.GRAN_BYTES // esize
    hw = H * W
    n_total = B * C * hw
    rows = {(0, 0), (B - 1, H - 1), (0, min(1, H - 1)),
            (B // 2, min(2, H - 1))}
    for b, h in sorted(rows):
        base0 = b * C * hw + h * W
        for (a, e), (wa, we) in blocks(plan, W, D, kind):
            for lo, hi, n in ((a, e, plan.tile), (wa, we, plan.span)):
                stride = spamat.row_stride(n, ge, hw)
                lead = spamat.stage_lead(base0, lo, ge)
                filled = {}
                for r, sh, x, count in spamat.stage_copies(
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


def test_plans_at_the_model_shapes():
    """Whole rows where the rows fill the card; split rows where they do
    not; 16-byte granules hold 8 bf16 values."""
    serve1 = spamat.moments_plan(1, 72, 60, 108, 24, 2)
    assert serve1.segs == 3 and serve1.tile == 36 and serve1.threads == 128
    train3 = spamat.moments_plan(8, 8, 162, 486, 216, 2)
    assert (train3.segs, train3.tile, train3.span) == (1, 486, 486)
    assert spamat.dtar_plan(8, 72, 18, 54, 24, 2).lanes == 16
    assert spamat.moments_plan(1, 8, 540, 972, 216, 2).lanes == 8
    assert spamat.row_stride(486, 8, 162 * 486) % 8 == (162 * 486) % 8
