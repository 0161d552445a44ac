#!/usr/bin/env python3
"""Smoke run of the PyTorch port (decnet_tpu_torch) on one NVIDIA card.

Builds the port's CUDA kernels with nvcc and the demo's host mask library
with g++, holds each kernel against its plain PyTorch version on the card
and times both: the forward kernels (sparse matching moments, disparity
warp) at the three fine-stage shapes of one 540x972 request and of a
training batch, the backward kernels (dRef, dTar) at the training shapes,
once windowed and once on adversarial inputs.  Then it drives the two main
paths: it loads the faithful checkpoint in bf16 and serves a few seeded
synthetic stereo requests through `decnet_tpu_torch.cli.demo` (host masks,
then `predict`), and it trains the
faithful model from that checkpoint for a few steps through
`decnet_tpu_torch.cli.train` (batch 8 of 162x486 crops of the on-device
stream, max_disp 216, bf16, batch-statistic BN), holding a kernel-path step
against a plain-path step and against kernel paths with planted faults.
It serves the s2d model with learned detail masks and windowed matching
(runs/ckpt_detail_r5) through the same demo entry points, kernel path
against plain path, and trains it from that checkpoint by its recipe
through the train CLI (batch 8 of 162x486, bf16, alpha times the detail
mask loss; the moments, dRef and dTar windowed inside the step), holding
its kernel path against its plain path, rejecting planted faults, and
resuming a saved run bit for bit.  It evaluates ckpt_faithful (legacy stream) and
ckpt_detail_r5 (default stream) by `decnet_tpu_torch.cli.report_eval` at
the JAX reports' protocol (540x972, max_disp 216, 24 batches of 4, seed
37, bf16), each held to its JAX accuracy anchor within a band fixed in
advance.  The windowed moments are held against their plain version at
that path's shapes too, and the windowed moments, dRef and dTar at the
s2d training step's.  The moments and the warp are also held at the
benchmark suites' shapes (KITTI served, Middlebury-H, whose forward splits
rows, and Middlebury-F), dRef and dTar at KITTI's training crop, and
the moments and warp at the bench's batch (B = 4).  It runs
`decnet_tpu_torch.cli.bench` at its full size (the s2d, faithful-repacked
and faithful variants at B = 4 of 540x972, bf16), printing its JSON line
and holding the repacked variant against the faithful one (the timed
models' predictions, and ckpt_faithful's trained weights repacked to
s2d_stages 2 against the checkpoint in faithful form, in f32, and in bf16
each form against the f32 answer), and serves
the flagship configuration (s2d_stages 2, learned quantile masks, window
12) on fresh weights, kernel path against plain path.
Then it makes the suites' files in a temporary directory (SceneFlow packs
of the eval phase's 96 scenes, KITTI packs, Middlebury-H pickles of two
ndisp) and drives the data path: `cli.eval` of ckpt_faithful on each suite
(SceneFlow held to the faithful anchor's band, KITTI and Middlebury kernel
path against plain path, submission PNGs read back), one Middlebury-F
forward for its time and memory, `cli.eval --exec_s2d 1` on the SceneFlow
packs against the plain run, a `train.packed_exec` frozen-BN step against
the faithful one (per gradient leaf, rejecting a planted fault),
`cli.train` from the packs (the step
checks with planted faults, the host's wait for batches), from KITTI and
from the host synthetic dataset, ckpt_faithful in the reference's `.pkl`
form served bit-equal through `--resume`, and `cli.demo` on PNG scenes
with both mask sources; the directory is removed at the end.
Last it decodes the committed DrivingStereo fixture's JPEG files
(tests/fixtures/drivingstereo) on the host, each against the SHA-256 of
cv2's decode in its manifest, and evaluates ckpt_faithful on them by
`cli.eval` against the JAX CLI's EPE recorded there; serves and trains
the model configurations beyond the faithful one (the cat and ssd costs,
group norm, 3, 2 and 1 stages; fresh weights, kernel path against plain
path); runs the Middlebury-F forward with the bicubic skip of stage 3
beside the unskipped one; and holds the standalone SpaMat and SpaVar ops
against their plain versions, rejecting zeroed backward kernels.
One line is printed per phase as it ends; the line before the last is a
JSON object describing every kernel, the last line is the device record.
Any failed check ends the run with a non-zero exit.

Usage:  python3 chip_smoke.py [--seed 0] [--out FILE.json]
Needs one CUDA card; without one it exits non-zero and prints no result.
It writes the kernels' build directory, a parameter snapshot under it,
--out when given, and the suites' files in a temporary directory
(~1.5 GB, removed at the end).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import inspect
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "runs", "ckpt_faithful")
# the s2d model with learned (quantile) detail masks and windowed matching
CKPT_DETAIL = os.path.join(ROOT, "runs", "ckpt_detail_r5")

# H100 SXM data-sheet peaks (dense): HBM bytes/s and f32 CUDA-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
DEV = "cuda"
# one 540x972 request (SceneFlow's 540x960 padded to x27), max_disp 216
SERVE = (540, 972, 216)
# (C, H, W, D) of the fine stages 1..3 of that request
STAGES = [(72, 60, 108, 24), (24, 180, 324, 72), (8, 540, 972, 216)]
# ... and of a training batch: B = 8 crops of 162x486, max_disp 216
TRAIN_B = 8
TRAIN_STAGES = [(72, 18, 54, 24), (24, 54, 162, 72), (8, 162, 486, 216)]
# (B, stage) of smaller training batches, whose B*H rows are too few to
# fill the card, so that the backward kernels split each row into segments
# (dref_plan / dtar_plan: 3 and 2 a row)
SPLIT_ROW_STAGES = [(2, TRAIN_STAGES[1]), (1, TRAIN_STAGES[2])]
TRAIN_STEPS = 5           # timed, after one warm-up step (rate 0)
TRAIN_S2D_STEPS = 3       # the same for ckpt_detail_r5's recipe
# the windows of match_window 12 at the fine stages: max(2, round(12 / 9)),
# round(12 / 3), 12
WINDOWS = (2, 4, 12)
# the faithful run's (batch, crop h, crop w, max_disp, dtype): config.json
# holds it
TRAIN_SHAPE = (TRAIN_B, 162, 486, 216, "bfloat16")
MASK_DENSITY = 0.2
# kernel vs plain tolerances, f32 accumulation both sides:
#   moments: summation order of the C-term scores and of the band differ,
#            which moves each f32 sum by a few ulps: rtol 2e-4 (+1e-6 for
#            sums that underflow towards 0);
#   warp:    both round the same f32 expression; bf16 output may differ
#            by one bf16 ulp (2^-7 relative) where the f32 values differ.
MOMENTS_RTOL, MOMENTS_ATOL = 2e-4, 1e-6
WARP_TOL = {"float32": (0.0, 1e-5), "bfloat16": (2.0 ** -7, 1e-6)}
#   backward: max |kernel - plain| over the largest |plain| gradient.  f32:
#            the same f32 products summed in another order, and scores
#            recomputed in another order inside exp: 1e-4.  bf16 inputs:
#            the gradients are stored in bf16, which rounds each by up to
#            2^-9 relative: 2^-7.
BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
ADVERSARIAL_SCALE = 50.0  # features the forward skipped, scaled: each such
#                           pair's score is ~50x a candidate's
SERVE_MEAN_TOL = 0.05     # px, kernel path vs plain path, mean |delta|
#   train step, kernel path vs plain path on one batch and one set of
#   weights: the forward differs only by the moments' summation order (the
#   warp is bit-identical), which bf16 activations carry into the loss:
#   sound runs read 2.5e-4 relative, tolerance 1e-3.  The flattened
#   gradients, which also carry cuDNN's run-to-run order, read cosine
#   0.999974 (1 - cos = 2.6e-5); with dRef or dTar zeroed, 0.931 and 0.955
#   (1 - cos >= 4.5e-2).  The tolerance 0.999 sits near the geometric
#   middle of the two, ~40x from each.
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_COS = 0.999
#   a second check, on the gradient at the matching's inputs (the ref and
#   tar features of the three fine stages, read from the matching's
#   backward node in the kernel-path step): cosine against the plain
#   backward's on the same saved inputs and upstream gradient, the same
#   0.999.  With a window the matching scans ~13x fewer pairs than the
#   full band, so a zeroed backward kernel moves the whole gradient less;
#   and the two paths' windows are cut at centres that differ by the
#   forward's rounding, which moves the gradients at the matching's inputs
#   by more than the kernels do.  This check sees the kernels' own
#   outputs.  A fault is rejected when either check fails.
#   planted faults, each on the kernel path of that step.  The check must
#   reject a backward kernel's output zeroed.  The moments' band one
#   disparity short in the forward (an off-by-one) is only read: it moves
#   the loss by less than the summation order does (2.2e-4), and the
#   step's gradients turn non-finite (the backward's extra pairs are not
#   bounded by max_cost); the moments' own parity check is what holds the
#   forward kernel.  Each fault wraps the wrapper it replaces
#   (functools.wraps carries its launch counter over).
FAULTS = {
    "dref_zeroed": ("spamat_dref", True, lambda torch, real: (
        lambda *a, **k: torch.zeros_like(real(*a, **k)))),
    "dtar_zeroed": ("spamat_dtar", True, lambda torch, real: (
        lambda *a, **k: torch.zeros_like(real(*a, **k)))),
    "moments_band_short": ("moments", False, lambda torch, real: (
        lambda ref, tar, rm, tm, max_disp, *a: real(ref, tar, rm, tm,
                                                    max_disp - 1, *a))),
}
REQUESTS = 3              # served after one warm-up request
# the windowed moments at the s2d detail path's shapes (that request's fine
# stages; windows max(2, round(12 / 9)), round(12 / 3), 12)
WINDOWED_STAGES = [(C, H, W, D, win) for (C, H, W, D), win
                   in zip(STAGES, WINDOWS)]
# ... and at the training stages of ckpt_detail_r5's recipe (B = 8)
TRAIN_WINDOWED_STAGES = [(C, H, W, D, win) for (C, H, W, D), win
                         in zip(TRAIN_STAGES, WINDOWS)]
# the accuracy anchors: scripts/report_eval.py's protocol on the TPU
# (540x972, max_disp 216, 24 batches of 4, seed 37, the val stream), final
# EPE (stage3_epe) and the sparse-ablated final EPE of the JAX reports.
# The port's stream draws from torch.Generator, so its 96 images are
# another sample of the same distribution: a checkpoint passes when
# |EPE_port - EPE_JAX| <= 3 SE + 0.02 EPE_JAX, SE the standard error of
# the port's 24 per-batch final EPEs (band fixed before any card run).
EVAL = dict(h=540, w=972, max_disp=216, batch=4, batches=24, seed=37)
ANCHORS = (
    # checkpoint, stream variant, stage3_epe, ablate_sparse_final_epe,
    # the JAX report it comes from
    ("ckpt_faithful", "legacy", 3.0747, 3.2091,
     "runs/report_faithful_r4_legacy.json"),
    ("ckpt_detail_r5", "default", 2.4925, 2.5181,
     "runs/report_detail_r5.json"),
)
BAND_SE, BAND_REL = 3.0, 0.02
SPIN_CYCLES = 2_000_000   # ~1 ms of device time at H100 clocks


def fine_stages(H, W, D):
    """(C, H, W, D) of the three fine stages of a padded H x W input."""
    return [(72, H // 9, W // 9, D // 9), (24, H // 3, W // 3, D // 3),
            (8, H, W, D)]


# The benchmark suites' files, made at run time in a temporary directory
# from the port's synthetic streams.  SceneFlow: the eval phase's 96
# legacy-stream scenes (seed 37, 540x972) as packs (~1.45 GB), and the
# first 24 of them less their 12 leftmost columns, SceneFlow's 540x960,
# which the datasets pad back with 12 zero columns (the faithful
# checkpoint, trained on unpadded scenes, reads EPE ~7.8 on those: the
# band alone, with the unpadded scenes' own masks, takes a scene from ~3.0
# to ~7.6 px on the CPU), for training and the demo; KITTI: 375x1242
# (padded to 378x1242), object masks in the 8th channel, its train_eval
# split served at B = 1 and its training crop 270x513 at B = 8;
# Middlebury-H: two 999x1485 scenes of ndisp 289 and 150 (forwards at 297
# and 162); Middlebury-F: one forward at 1998x2970, ndisp 810, for its
# time and peak memory.
SF_SCENES, SF_SHAPE, SF_CUT = 96, (540, 960), 12
SF_CUT_SCENES = 24
SF_BATCH = 4
KITTI_SHAPE, KITTI_SCENES = (375, 1242), 8
KITTI_CROP = (270, 513)
MID_H_SHAPE, MID_H_NDISP = (999, 1485), (289, 150)
MID_F_SHAPE, MID_F_NDISP = (1998, 2970), 810
SUITE_STAGES = {"kitti": fine_stages(378, 1242, 216),
                "middlebury_h": fine_stages(999, 1485, 297),
                "middlebury_f": fine_stages(1998, 2970, 810)}
KITTI_TRAIN_STAGES = fine_stages(*KITTI_CROP, 216)
SUITE_BYTES = 2.1e9       # the packs' ~1.8 GB and the rest, on disk
# The SceneFlow-pack eval of ckpt_faithful: its scenes are the eval
# phase's, but `cli.eval` scores each sample over 0 < gt < its ndisp, 192
# for SceneFlow (the reference's eval), where the report pools a batch
# over gt < 216.  The faithful legacy anchor's band (3.0747 +- 3 SE + 2%)
# is printed beside it; what is held is the like-for-like reading: the
# same checkpoint on the same stream batches, scored as `cli.eval` scores
# them.  The inputs are equal (the packs reproduce the stream's views, gt
# and masks bit for bit on the CPU), so only cuDNN's order and the host
# masks' arithmetic separate the two: mean EPE within 0.02 px, every
# batch within 0.05.
SF_ANCHOR = ANCHORS[0]
SF_STREAM_TOL, SF_BATCH_TOL = 0.02, 0.05
SCENEFLOW_NDISP = 192
TRAIN_DISK_STEPS = 5      # timed steps from the packs, after a warm-up
SUBMISSION_TOL = 1.0 / 256   # px: a uint16 PNG holds floor(256 d)


def phase(name, t0, **info):
    fields = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[phase {name}] {time.perf_counter() - t0:.2f}s {fields}",
          flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_cuda(torch, fn, iters, flush_buf):
    """Mean device ms of `fn` over `iters` launches, each after an L2
    flush (a write of `flush_buf`; none when it is None).  A ~1 ms spin on
    the card before the start event lets the host enqueue `fn` meanwhile,
    so the events time the device, not the Python and launch overhead
    (which a plain version's many launches still pay)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush_buf is not None:
            flush_buf.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def candidate_pairs(torch, rm, tm, D, center=None, window=0):
    """(active query, candidate key) pairs of the band, cut to
    |d - center| <= window when window > 0: the work the moments kernel
    does on these masks."""
    W = tm.shape[-1]
    c = torch.nn.functional.pad((tm != 0).double().cumsum(-1), (1, 0))
    w = torch.arange(W, device=tm.device)
    d_lo = torch.zeros_like(w)
    d_hi = torch.clamp(w, max=D - 1)
    if window > 0:
        d_lo = torch.clamp(torch.ceil(center - window), min=0).long()
        d_hi = torch.minimum(torch.floor(center + window).long(), d_hi)
    # source columns x - d_hi .. x - d_lo, clamped where the range is empty
    lo = torch.clamp(w - d_hi, 0, W - 1)
    hi = torch.clamp(w - d_lo, 0, W - 1)
    cnt = torch.where(d_hi >= d_lo, c.gather(-1, (hi + 1).expand_as(tm).long())
                      - c.gather(-1, lo.expand_as(tm).long()), 0.0)
    return float((cnt * (rm != 0)).sum())


def bound(nbytes, flops):
    """(bound ms, what bounds it) on the data-sheet peaks."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def smooth_center(torch, gen, B, H, W, D):
    """A smooth disparity field in [0, D), as the dense prediction gives
    the window's centres: a 4x4 grid of uniform values, bilinear."""
    coarse = torch.rand(B, 1, 4, 4, generator=gen, device=DEV) * D
    return torch.nn.functional.interpolate(
        coarse, size=(H, W), mode="bilinear",
        align_corners=False)[:, 0].contiguous()


def stage_inputs(torch, gen, B, C, H, W, D):
    """Random 20%-dense masks, f32 features and disparities in [0, D)."""
    dev = DEV
    rm = (torch.rand(B, H, W, generator=gen, device=dev)
          < MASK_DENSITY).float()
    tm = (torch.rand(B, H, W, generator=gen, device=dev)
          < MASK_DENSITY).float()
    feat32 = torch.randn(B, C, H, W, generator=gen, device=dev)
    tar32 = torch.randn(B, C, H, W, generator=gen, device=dev)
    disp = torch.rand(B, H, W, generator=gen, device=dev) * D
    return rm, tm, feat32, tar32, disp


def kernel_parity(torch, spamat, kwarp, gen, flush_buf, stages=None, B=1):
    """Each kernel against its plain version at the stage shapes (those of
    one served request by default), f32 and bf16; times in bf16 (the served
    and trained dtype).  Returns per-kernel records."""
    F = torch.nn.functional
    dev = DEV
    rec = {"spamat_moments": [], "warp": []}
    for C, H, W, D in stages or STAGES:
        rm, tm, feat32, tar32, disp = stage_inputs(torch, gen, B, C, H, W, D)
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[-1]
            ref, tar = feat32.to(dt), tar32.to(dt)
            # -- moments
            got = spamat.moments(ref, tar, rm, tm, D)
            want = spamat.moments_plain(ref, tar, rm, tm, D)
            torch.cuda.synchronize()
            act = rm != 0
            abs_err = rel_err = 0.0
            for g, w in zip(got, want):
                g, w = g[act], w[act]
                if not torch.isfinite(g).all():
                    fail(f"moments C={C} {dname}: non-finite output")
                d = (g - w).abs()
                abs_err = max(abs_err, float(d.max()))
                rel_err = max(rel_err, float((d / (w.abs() + 1e-30)).max()))
                if bool((d > MOMENTS_ATOL + MOMENTS_RTOL * w.abs()).any()):
                    fail(f"moments C={C} H={H} W={W} D={D} {dname}: "
                         f"max abs err {float(d.max()):.3e} past tolerance")
            r = {"shape": [C, H, W, D], "dtype": dname,
                 "max_abs_err": abs_err, "max_rel_err": rel_err}
            if dt == torch.bfloat16:
                mp = spamat.moments_plan(B, C, H, W, D, ref.element_size())
                r["plan"] = f"segs={mp.segs},tile={mp.tile},lanes={mp.lanes}"
                pairs = candidate_pairs(torch, rm, tm, D)
                nbytes = (2 * ref.numel() * ref.element_size()
                          + 2 * rm.numel() * 4 + 4 * rm.numel() * 4)
                flops = pairs * (2 * C + 8)
                bms, by = bound(nbytes, flops)
                r.update(
                    ms=time_cuda(torch, lambda: spamat.moments(
                        ref, tar, rm, tm, D), 20, flush_buf),
                    plain_ms=time_cuda(torch, lambda: spamat.moments_plain(
                        ref, tar, rm, tm, D), 3, flush_buf),
                    bytes=nbytes, flops=flops, bound_ms=bms, bound_by=by,
                    library_ms=None)
            rec["spamat_moments"].append(r)
            print(f"  moments C={C} {H}x{W} D={D} {dname}: "
                  + " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in r.items()
                             if k not in ("shape", "dtype")), flush=True)
            # -- warp
            got = kwarp.warp(ref, disp, D)
            want = kwarp.warp_plain(ref, disp, D)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            rtol, atol = WARP_TOL[dname]
            if not torch.isfinite(got.float()).all() or bool(
                    (d > atol + rtol * want.float().abs()).any()):
                fail(f"warp C={C} {H}x{W} {dname}: max abs err "
                     f"{float(d.max()):.3e} past tolerance")
            r = {"shape": [C, H, W, D], "dtype": dname,
                 "max_abs_err": float(d.max())}
            if dt == torch.bfloat16:
                wp = kwarp.warp_plan(B, C, H, W, ref.element_size())
                r["plan"] = f"groups={wp.groups},cg={wp.cg}"
                # the library yardstick: grid_sample over the same warp
                # (x = (w - d) W/(W-1) - 0.5 is gx = 2 (w - d)/(W-1) - 1)
                gx = 2.0 * (torch.arange(W, device=dev) - disp) / (W - 1) - 1
                gy = (2.0 * torch.arange(H, device=dev) / (H - 1) - 1)
                grid = torch.stack([gx, gy.view(1, H, 1).expand_as(gx)], -1)
                grid = grid.to(dt)
                nbytes = 2 * ref.numel() * ref.element_size() + disp.numel() * 4
                flops = ref.numel() * 30.0
                bms, by = bound(nbytes, flops)
                r.update(
                    ms=time_cuda(torch, lambda: kwarp.warp(ref, disp, D), 20,
                                 flush_buf),
                    plain_ms=time_cuda(torch, lambda: kwarp.warp_plain(
                        ref, disp, D), 5, flush_buf),
                    bytes=nbytes, flops=flops, bound_ms=bms, bound_by=by,
                    library_ms=time_cuda(torch, lambda: F.grid_sample(
                        ref, grid, align_corners=False), 20, flush_buf),
                    # a copy of the features: the same bytes read and
                    # written once, by the timing above
                    copy_ms=time_cuda(torch, ref.clone, 20, flush_buf))
            rec["warp"].append(r)
            print(f"  warp C={C} {H}x{W} D={D} {dname}: "
                  + " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in r.items()
                             if k not in ("shape", "dtype")), flush=True)
    return rec


def backward_residuals(torch, spamat, ref, tar, rm, tm, D, center=None,
                       window=0):
    """out, sum_sim, max_cost of the forward, as the matching Function
    saves them (from the moments kernel)."""
    m, se, sed, _ = spamat.moments(ref, tar, rm, tm, D, center, window)
    refm = rm != 0
    eps = spamat.EPS
    out = torch.where(refm, (eps + sed) / (eps + se), 0.0)
    return (out, torch.where(refm, eps + se, 0.0),
            torch.where(refm, m, 0.0))


def backward_parity(torch, spamat, gen, flush_buf, cases=None, suffix=""):
    """The dRef and dTar kernels against `spamat_backward_plain` at the
    training stage shapes (B = 8), f32 and bf16, once windowed, once
    adversarial: the features of masked-out keys and of inactive queries
    scaled by ADVERSARIAL_SCALE, so that every pair the forward skipped
    outscores max_cost (0 at an inactive query) by far, and an ungated exp
    overflows; and at SPLIT_ROW_STAGES, f32 and bf16, where a block owns a
    segment of a row and its window starts inside the row.  Times in bf16
    at B = 8.  Then windowed as the s2d training step runs them: at the
    three training shapes with windows 2 / 4 / 12 around a smooth centre
    (`smooth_center`), f32 and bf16, timed in bf16 (records under
    "<name>_windowed").  Other `cases` (B, (C, H, W, D), dtype, window,
    adversarial, smooth centre) instead: records under "<name><suffix>".
    Returns per-kernel records."""
    dts = (torch.float32, torch.bfloat16)
    if cases is None:
        cases = [(TRAIN_B, shape, dt, 0, False, False)
                 for shape in TRAIN_STAGES for dt in dts]
        cases.append((TRAIN_B, TRAIN_STAGES[1], torch.float32, 6, False,
                      False))
        cases.append((TRAIN_B, TRAIN_STAGES[0], torch.bfloat16, 0, True,
                      False))
        cases += [(B, shape, dt, 0, False, False)
                  for B, shape in SPLIT_ROW_STAGES for dt in dts]
        cases += [(TRAIN_B, (C, H, W, D), dt, win, False, True)
                  for C, H, W, D, win in TRAIN_WINDOWED_STAGES for dt in dts]
    rec = {}
    for B, (C, H, W, D), dt, window, adversarial, smooth in cases:
        rm, tm, feat32, tar32, disp = stage_inputs(torch, gen, B, C, H, W, D)
        if adversarial:
            feat32 = torch.where((rm == 0)[:, None], feat32 * ADVERSARIAL_SCALE,
                                 feat32)
            tar32 = torch.where((tm == 0)[:, None], tar32 * ADVERSARIAL_SCALE,
                                tar32)
        dname = str(dt).split(".")[-1]
        ref, tar = feat32.to(dt), tar32.to(dt)
        center = (smooth_center(torch, gen, B, H, W, D) if smooth
                  else disp if window else None)
        out, ss, mc = backward_residuals(torch, spamat, ref, tar, rm, tm, D,
                                         center, window)
        g = torch.randn(B, H, W, generator=gen, device=DEV)
        args = (ref, tar, rm, tm, out, ss, mc, g, D, center, window)
        w = spamat.query_weight(g, rm, ss).contiguous()
        kargs = (ref, tar, tm, mc, out, w, D, center, window)
        got = (spamat.spamat_dref(*kargs), spamat.spamat_dtar(*kargs))
        want = spamat.spamat_backward_plain(*args)
        torch.cuda.synchronize()
        pairs = candidate_pairs(torch, rm, tm, D, center, window)
        names = (["spamat_dref_windowed", "spamat_dtar_windowed"] if smooth
                 else [f"spamat_dref{suffix}", f"spamat_dtar{suffix}"])
        for name, gk, gp in zip(names, got, want):
            case = (f"{name} B={B} C={C} H={H} W={W} D={D} {dname} "
                    f"window={window}" + (" adversarial" if adversarial
                                          else ""))
            if not (torch.isfinite(gk.float()).all()
                    and torch.isfinite(gp.float()).all()):
                fail(f"{case}: non-finite output")
            scale = float(gp.float().abs().max())
            err = float((gk.float() - gp.float()).abs().max())
            rel = err / max(scale, 1e-30)
            if not rel <= BWD_TOL[dname]:
                fail(f"{case}: max err {err:.3e} = {rel:.3e} of the largest "
                     f"gradient, past {BWD_TOL[dname]:.3g}")
            r = {"shape": [B, C, H, W, D], "dtype": dname, "window": window,
                 "adversarial": adversarial, "max_abs_err": err,
                 "rel_err": rel, "max_grad": scale}
            kname = "spamat_dref" if "dref" in name else "spamat_dtar"
            plan = getattr(spamat, kname.replace("spamat_", "") + "_plan")(
                B, C, H, W, D, ref.element_size())
            r["plan"] = f"segs={plan.segs},tile={plan.tile},lanes={plan.lanes}"
            if (dt == torch.bfloat16 and B == TRAIN_B and not adversarial
                    and (smooth or not window)):
                kernel = getattr(spamat, kname)
                # ref, tar, 4 f32 maps (and the centre) in; one gradient
                # out; per candidate pair 2C flops for the score, 2C to
                # accumulate, ~8 more
                nbytes = 3 * ref.numel() * ref.element_size() \
                    + (5 if window else 4) * rm.numel() * 4
                flops = pairs * (4 * C + 8)
                bms, by = bound(nbytes, flops)
                r.update(
                    ms=time_cuda(torch, lambda: kernel(*kargs), 20,
                                 flush_buf),
                    plain_ms=time_cuda(torch, lambda:
                                       spamat.spamat_backward_plain(*args), 3,
                                       flush_buf),
                    bytes=nbytes, flops=flops, pairs=pairs, bound_ms=bms,
                    bound_by=by, library_ms=None)
            rec.setdefault(name, []).append(r)
            print(f"  {case}: " + " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in r.items()
                if k not in ("shape", "dtype", "window", "adversarial")),
                flush=True)
    return rec


def flat_grads(torch, grads):
    return torch.cat([g.float().flatten() for g in grads])


@contextlib.contextmanager
def matching_backward_pairs(torch, spamat):
    """Per call of the sparse matching's backward in a step, a pair of
    flattened f32 vectors: the gradients it returned for its ref and tar
    features, and `spamat_backward_plain`'s on the same saved inputs and
    the same upstream gradient (computed by a pre-hook on the matching's
    autograd node, while its saved tensors are alive)."""
    from decnet_tpu_torch.models import decnet as tdecnet
    real = tdecnet.sparse_matching_with_var
    pairs = []
    flat = lambda gs: torch.cat([g.float().flatten() for g in gs])

    def hooked(*a, **k):
        out, var = real(*a, **k)
        node, plain = out.grad_fn, []

        def pre(go):
            ref, tar, rm, tm, center, o, ss, mc = node.saved_tensors
            max_disp, window, _ = node.cfg
            plain.append(flat(spamat.spamat_backward_plain(
                ref, tar, rm, tm, o, ss, mc, go[0].contiguous(), max_disp,
                center, window)))

        def post(gi, go):
            pairs.append((flat(gi[:2]), plain.pop()))
        if node is not None:
            node.register_prehook(pre)
            node.register_hook(post)
        return out, var
    tdecnet.sparse_matching_with_var = hooked
    try:
        yield pairs
    finally:
        tdecnet.sparse_matching_with_var = real


def step_checks(torch, spamat, model, b, cfg, where, faults=None):
    """A kernel-path step held against a plain-path step on one batch and
    one set of weights (loss, the whole gradient's cosine), and in the
    kernel-path step the gradient at the matching's inputs against the
    plain backward's on the same inputs (`matching_backward_pairs`; a
    model with no fine stage has none); then the same against kernel
    paths with each planted fault of `faults` (FAULTS by default), which
    must be rejected where it says so.  The model's state is put back
    after each step."""
    from decnet_tpu_torch.train.step import loss_and_grads
    faults = FAULTS if faults is None else faults
    n_fine = len(range(1, min(cfg.model.num_stage, cfg.model.skip_stage_id)))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def run_step(use_kernels):
        model.use_kernels = use_kernels
        try:
            with matching_backward_pairs(torch, spamat) as pairs:
                lg, grads = loss_and_grads(model, b, cfg)
        finally:
            model.load_state_dict(state)
            model.use_kernels = True
        if len(pairs) != n_fine:
            fail(f"{where}: the matching's backward ran {len(pairs)} times, "
                 f"not {n_fine}")
        return (float(lg["total"]), flat_grads(torch, grads),
                [torch.cat(x) for x in zip(*pairs)] if pairs else None)

    # in f64: an f32 cosine of ~1e7 terms is off by up to ~1e-3
    cos = lambda x, y: float(torch.nn.functional.cosine_similarity(
        x.double(), y.double(), dim=0))
    lp, gp, _ = run_step(False)

    def against_plain(lk, gk, matching):
        """(loss relative error, gradient cosine, matching-input gradient
        cosine), and whether all are accepted."""
        rel, c = abs(lk - lp) / abs(lp), cos(gk, gp)
        mc = cos(*matching) if matching else float("nan")
        ok = (torch.isfinite(gk).all() and rel <= TRAIN_LOSS_RTOL
              and c >= TRAIN_GRAD_COS
              and (not matching or mc >= TRAIN_GRAD_COS))
        return rel, c, mc, bool(ok)

    lk, gk, mk = run_step(True)
    loss_rel, grad_cos, match_cos, ok = against_plain(lk, gk, mk)
    print(f"  {where} kernel vs plain: loss rel {loss_rel:.4g} gradient "
          f"cosine {grad_cos:.7g} matching-input cosine {match_cos:.7g}",
          flush=True)
    if not ok:
        fail(f"{where} step kernel vs plain: loss rel {loss_rel:.3e} (tol "
             f"{TRAIN_LOSS_RTOL}), gradient cosine {grad_cos:.6f}, "
             f"matching-input cosine {match_cos:.6f} (tol {TRAIN_GRAD_COS}),"
             f" finite {bool(torch.isfinite(gk).all())}")
    planted_faults = {}
    for fault, (name, must_reject, planted) in faults.items():
        real = getattr(spamat, name)
        setattr(spamat, name, functools.wraps(real)(planted(torch, real)))
        try:
            rel, c, mc, passed = against_plain(*run_step(True))
        finally:
            setattr(spamat, name, real)
        planted_faults[fault] = {"loss_rel": rel, "grad_cos": c,
                                 "matching_grad_cos": mc,
                                 "rejected": not passed}
        print(f"  {where} planted fault {fault}: loss rel {rel:.4g} "
              f"gradient cosine {c:.7g} matching-input cosine {mc:.7g}"
              f" -> {'rejected' if not passed else 'passed'}", flush=True)
        if passed and must_reject:
            fail(f"{where}: the kernel vs plain step check passed with "
                 f"{fault}")
    return {"plain_loss_rel": loss_rel, "plain_grad_cos": grad_cos,
            "plain_matching_grad_cos": match_cos,
            "planted_faults": planted_faults, "kernel_loss": lk,
            "plain_loss": lp}


def train_phase(torch, counters):
    """A few optimizer steps of the faithful model from the checkpoint
    through the train CLI's entry (`prepare`, then `Run.step`), with the
    checks this run can make; then a kernel-path step held against a
    plain-path step on one batch, the same check against kernel paths with
    planted faults (it must reject a zeroed backward kernel), and one
    freeze-BN step."""
    from decnet_tpu_torch.cli import train as tcli
    from decnet_tpu_torch.ops.kernels import spamat
    from decnet_tpu_torch.train.checkpoint import save_params
    from decnet_tpu_torch.train.step import train_step

    ckpt_out = os.path.join(ROOT, "build", "decnet_tpu_torch", "smoke_ckpt")
    run = tcli.prepare(["--config", os.path.join(CKPT, "config.json"),
                        "--dataset", "synthetic", "--init_from", CKPT,
                        "--steps", str(TRAIN_STEPS + 1), "--ckpt_dir",
                        ckpt_out, "--device", DEV])
    cfg, model = run.cfg, run.state.model
    shape = (cfg.train.batch_size, cfg.train.crop_h, cfg.train.crop_w,
             cfg.model.max_disp, cfg.model.dtype)
    if shape != TRAIN_SHAPE:
        fail(f"train config {shape} is not the faithful run's")

    def snapshot(kind):
        return {k: v.detach().clone() for k, v in model.state_dict().items()
                if (k.endswith(("running_mean", "running_var")))
                == (kind == "stats")}

    def moved(before):
        now = model.state_dict()
        return sum(not torch.equal(now[k], v) for k, v in before.items())

    def finite_logs(logs, where):
        vals = {k: float(v) for k, v in logs.items()}
        bad = [k for k, v in vals.items() if not math.isfinite(v)]
        if bad:
            fail(f"train {where}: non-finite {bad}")
        return vals

    # warm-up step: rate 0, so the parameters must not move
    p0, s0 = snapshot("params"), snapshot("stats")
    t = time.perf_counter()
    first = finite_logs(run.step(next(run.stream)), "step 1")
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t) * 1e3
    if moved(p0):
        fail("step 1 (rate 0) moved parameters")
    if moved(s0) == 0:
        fail("step 1 did not move the BN running statistics")
    # timed steps, the counts read around exactly these steps
    batches = [next(run.stream) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    p1 = snapshot("params")
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    logs, ms = [], []
    for i, b in enumerate(batches):
        t = time.perf_counter()
        out = run.step(b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        logs.append(finite_logs(out, f"step {i + 2}"))
        if i == 0 and moved(p1) == 0:
            fail("step 2 moved no parameter")
    launches = {k: c.launches for k, c in counters.items()}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    want = 3 * TRAIN_STEPS
    for k, n in launches.items():
        if n != want:
            fail(f"{k} launched {n} times in {TRAIN_STEPS} train steps, "
                 f"expected {want}")
    for i, (l, m) in enumerate(zip(logs, ms)):
        print(f"  step {i + 2}: {m:.2f} ms loss={l['total']:.5f} "
              f"grad_norm={l['grad_norm']:.4f}", flush=True)

    checks = step_checks(torch, spamat, model, batches[-1], cfg, "train")
    # one freeze-BN step: running statistics bit-identical, parameters move
    s1, p2 = snapshot("stats"), snapshot("params")
    finite_logs(train_step(run.state, batches[-1], cfg, freeze_bn=True),
                "freeze step")
    if moved(s1) or not moved(p2):
        fail("freeze-BN step moved the BN statistics or no parameter")
    path = save_params(ckpt_out, model, cfg)
    import numpy as np
    with np.load(path) as z:
        if len(z.files) != 374:
            fail(f"snapshot holds {len(z.files)} arrays, not 374")
    return {"launches": launches, "step_ms": ms, "warmup_ms": warm_ms,
            "peak_mem_mb": peak_mb, "first_loss": first["total"],
            "losses": [l["total"] for l in logs],
            "grad_norms": [l["grad_norm"] for l in logs], **checks}


@contextlib.contextmanager
def recorded_windows(module, names):
    """Replaces each kernel wrapper `module.<name>` by one that records the
    window each call receives (0 without a centre) and calls it.  The
    wrappers count their launches on their module-level name, so the
    count moves to the stand-in while it is installed and back after."""
    seen = {n: [] for n in names}
    real = {n: getattr(module, n) for n in names}

    def stand_in(n):
        sig = inspect.signature(real[n])

        def call(*a, **k):
            args = sig.bind(*a, **k)
            args.apply_defaults()
            seen[n].append(int(args.arguments["window"])
                           if args.arguments["center"] is not None else 0)
            return real[n](*a, **k)
        return functools.update_wrapper(call, real[n])
    for n in names:
        setattr(module, n, stand_in(n))
    try:
        yield seen
    finally:
        for n in names:
            real[n].launches = getattr(module, n).launches
            setattr(module, n, real[n])


def train_s2d_phase(torch, counters):
    """ckpt_detail_r5's recipe trained from its checkpoint through the
    train CLI's entry (`prepare`, then `Run.step`): the s2d model with
    quantile learned masks, windowed matching, alpha times the detail mask
    loss.  A rate-0 warm-up step, TRAIN_S2D_STEPS timed steps with their
    launches and the windows the kernel wrappers received, the kernel vs
    plain step check with planted faults (`step_checks`), then a resume
    round trip: save, `prepare` a fresh run on the same directory, and
    require the same parameters, BN statistics, optimizer state, step and
    next batch, bit for bit."""
    import numpy as np
    from decnet_tpu_torch.cli import train as tcli
    from decnet_tpu_torch.ops.kernels import spamat
    from decnet_tpu_torch.train.checkpoint import PARAMS_FILE

    ckpt_out = os.path.join(ROOT, "build", "decnet_tpu_torch",
                            "smoke_ckpt_s2d")
    shutil.rmtree(ckpt_out, ignore_errors=True)   # a fresh run, not resumed
    argv = ["--config", os.path.join(CKPT_DETAIL, "config.json"),
            "--dataset", "synthetic", "--init_from", CKPT_DETAIL, "--steps",
            str(TRAIN_S2D_STEPS + 1), "--ckpt_dir", ckpt_out, "--device", DEV]
    run = tcli.prepare(argv)
    cfg, model = run.cfg, run.state.model
    m = cfg.model
    shape = (cfg.train.batch_size, cfg.train.crop_h, cfg.train.crop_w,
             m.max_disp, m.dtype)
    if shape != TRAIN_SHAPE or not (m.s2d_fine and m.use_detail
                                    and m.match_window == 12
                                    and m.thold_mode == "quantile"
                                    and cfg.loss.alpha > 0):
        fail(f"{CKPT_DETAIL} config {shape} is not the s2d + window + "
             f"quantile-detail recipe at the training shape")
    params = lambda: {k: v.detach().clone() for k, v in
                      model.named_parameters()}
    p0 = params()
    t = time.perf_counter()
    first = {k: float(v) for k, v in run.step(next(run.stream)).items()}
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t) * 1e3
    if any(not torch.equal(v, p0[k]) for k, v in model.named_parameters()):
        fail("train_s2d step 1 (rate 0) moved parameters")
    if not all(math.isfinite(v) for v in first.values()):
        fail(f"train_s2d step 1: non-finite logs {first}")
    batches = [next(run.stream) for _ in range(TRAIN_S2D_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    logs, ms = [], []
    with recorded_windows(spamat, ("moments", "spamat_dref",
                                   "spamat_dtar")) as windows:
        for b in batches:
            t = time.perf_counter()
            out = run.step(b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            logs.append({k: float(v) for k, v in out.items()})
    launches = {k: c.launches for k, c in counters.items()}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    want = 3 * TRAIN_S2D_STEPS
    for k, n in launches.items():
        if n != want:
            fail(f"train_s2d: {k} launched {n} times in {TRAIN_S2D_STEPS} "
                 f"steps, expected {want}")
    for k, ws in windows.items():
        if sorted(ws) != sorted(list(WINDOWS) * TRAIN_S2D_STEPS):
            fail(f"train_s2d: {k} received windows {ws}, expected "
                 f"{list(WINDOWS)} a step")
    for i, (l, t_ms) in enumerate(zip(logs, ms)):
        if not all(math.isfinite(v) for v in l.values()):
            fail(f"train_s2d step {i + 2}: non-finite logs")
        mask_terms = sum(l[f"mask{j}/{x}"] for j in range(3)
                         for x in ("focal", "l1"))
        print(f"  step {i + 2}: {t_ms:.2f} ms loss={l['total']:.5f} "
              f"grad_norm={l['grad_norm']:.4f} mask terms={mask_terms:.5f}",
              flush=True)

    checks = step_checks(torch, spamat, model, batches[-1], cfg, "train_s2d")

    # resume: save at the last step, then a fresh run on the directory
    run.ckpt.save(run.state, cfg)
    again = tcli.prepare(argv)
    if again.state.step != run.state.step:
        fail(f"resume: step {again.state.step}, saved {run.state.step}")
    sa, sb = model.state_dict(), again.state.model.state_dict()
    bad = [k for k in sa if not torch.equal(sa[k], sb[k])]
    oa = run.state.optimizer.state_dict()
    ob = again.state.optimizer.state_dict()
    bad += [f"optimizer {i}.{k}" for i, st in oa["state"].items()
            for k, v in st.items()
            if not torch.equal(v.cpu(), ob["state"][i][k].cpu())]
    if oa["param_groups"] != ob["param_groups"]:
        bad.append("optimizer param_groups")
    nxt, nxt_again = next(run.stream), next(again.stream)
    for k, v in nxt.items():
        pairs = zip(v, nxt_again[k]) if isinstance(v, list) else \
            [(v, nxt_again[k])]
        if not all(torch.equal(x, y) for x, y in pairs):
            bad.append(f"next batch {k}")
    if bad:
        fail(f"resume is not bit-exact: {bad[:5]} ({len(bad)} differ)")
    stats = sum(k.endswith(("running_mean", "running_var")) for k in sa)
    del again
    with np.load(os.path.join(CKPT_DETAIL, PARAMS_FILE)) as z:
        n_ref = len(z.files)
    for path in (os.path.join(ckpt_out, str(run.state.step), PARAMS_FILE),
                 os.path.join(ckpt_out, PARAMS_FILE)):
        with np.load(path) as z:
            if len(z.files) != n_ref:
                fail(f"{path} holds {len(z.files)} arrays, "
                     f"{CKPT_DETAIL} {n_ref}")
    print(f"  resume: step {run.state.step}, {len(sa)} tensors ({stats} BN "
          f"statistics), {len(oa['state'])} optimizer states and the next "
          f"batch bit-equal; params.npz {n_ref} arrays", flush=True)
    return {"launches": launches, "windows": windows, "step_ms": ms,
            "warmup_ms": warm_ms, "peak_mem_mb": peak_mb,
            "first_loss": first["total"],
            "losses": [l["total"] for l in logs],
            "grad_norms": [l["grad_norm"] for l in logs],
            "resume_bit_exact": True, "params_npz_arrays": n_ref, **checks}


def kernel_parity_extra(torch, spamat, kwarp, gen):
    """The modes the served path does not reach, held against the plain
    versions too: a batch of two, and the windowed moments (|d - center|
    <= window), at the stage-2 shape in f32."""
    B, (C, H, W, D), window = 2, STAGES[1], 6
    rm = (torch.rand(B, H, W, generator=gen, device=DEV) < 0.5).float()
    tm = (torch.rand(B, H, W, generator=gen, device=DEV) < 0.5).float()
    ref = torch.randn(B, C, H, W, generator=gen, device=DEV)
    tar = torch.randn(B, C, H, W, generator=gen, device=DEV)
    center = torch.rand(B, H, W, generator=gen, device=DEV) * D
    errs = {}
    for name, kw in (("moments_b2", {}),
                     ("moments_b2_window", dict(center=center,
                                                window=window))):
        got = spamat.moments(ref, tar, rm, tm, D, **kw)
        want = spamat.moments_plain(ref, tar, rm, tm, D, **kw)
        act = rm != 0
        err = 0.0
        for g, w in zip(got, want):
            d = (g[act] - w[act]).abs()
            err = max(err, float(d.max()))
            if bool((d > MOMENTS_ATOL + MOMENTS_RTOL * w[act].abs()).any()):
                fail(f"{name}: max abs err {float(d.max()):.3e} past "
                     f"tolerance")
        errs[name] = err
    disp = torch.rand(B, H, W, generator=gen, device=DEV) * D
    d = (kwarp.warp(ref, disp, D) - kwarp.warp_plain(ref, disp, D)).abs()
    if float(d.max()) > WARP_TOL["float32"][1]:
        fail(f"warp_b2: max abs err {float(d.max()):.3e} past tolerance")
    errs["warp_b2"] = float(d.max())
    return errs


def windowed_parity(torch, spamat, gen, flush_buf, stages=None, B=1):
    """The windowed moments against their plain version at the s2d detail
    path's stage shapes (one request by default; TRAIN_WINDOWED_STAGES at
    B = 8 for its training step), f32 and bf16, the centres a smooth
    disparity in [0, D) as the dense prediction gives them; times in
    bf16.  Returns the per-shape records."""
    recs = []
    for C, H, W, D, win in stages or WINDOWED_STAGES:
        rm, tm, feat32, tar32, _ = stage_inputs(torch, gen, B, C, H, W, D)
        center = smooth_center(torch, gen, B, H, W, D)
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[-1]
            ref, tar = feat32.to(dt), tar32.to(dt)
            got = spamat.moments(ref, tar, rm, tm, D, center, win)
            want = spamat.moments_plain(ref, tar, rm, tm, D, center, win)
            torch.cuda.synchronize()
            act = rm != 0
            err = 0.0
            for g, w in zip(got, want):
                g, w = g[act], w[act]
                if not torch.isfinite(g).all():
                    fail(f"windowed moments C={C} {dname}: non-finite")
                d = (g - w).abs()
                err = max(err, float(d.max()))
                if bool((d > MOMENTS_ATOL + MOMENTS_RTOL * w.abs()).any()):
                    fail(f"windowed moments C={C} H={H} W={W} D={D} "
                         f"window={win} {dname}: max abs err "
                         f"{float(d.max()):.3e} past tolerance")
            r = {"shape": [C, H, W, D], "window": win, "dtype": dname,
                 "max_abs_err": err}
            if dt == torch.bfloat16:
                pairs = candidate_pairs(torch, rm, tm, D, center, win)
                # ref, tar, 2 masks and the centre in; 4 maps out
                nbytes = (2 * ref.numel() * ref.element_size()
                          + 3 * rm.numel() * 4 + 4 * rm.numel() * 4)
                bms, by = bound(nbytes, pairs * (2 * C + 8))
                r.update(
                    ms=time_cuda(torch, lambda: spamat.moments(
                        ref, tar, rm, tm, D, center, win), 20, flush_buf),
                    plain_ms=time_cuda(torch, lambda: spamat.moments_plain(
                        ref, tar, rm, tm, D, center, win), 3, flush_buf),
                    pairs=pairs, bytes=nbytes, bound_ms=bms, bound_by=by,
                    library_ms=None)
            recs.append(r)
            print(f"  windowed moments B={B} C={C} {H}x{W} D={D} "
                  f"window={win} {dname}: " + " ".join(
                      f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                      for k, v in r.items()
                      if k not in ("shape", "dtype", "window")), flush=True)
    return recs


def serve_s2d_phase(torch, spamat, kwarp, gen):
    """ckpt_detail_r5 (s2d, learned quantile masks, windowed matching)
    served as the demo serves it: `request_masks` (none: the heads make
    them), then `predict`; the launches of the timed requests, and the
    kernel path held against the plain path on the same requests."""
    from decnet_tpu_torch.cli.demo import predict, request_masks
    from decnet_tpu_torch.data.synthetic import synthetic_pair
    from decnet_tpu_torch.weights import load_checkpoint
    H, W, D = SERVE
    n = REQUESTS
    model = load_checkpoint(CKPT_DETAIL, device=DEV)
    cfg = model.cfg
    if not (cfg.s2d_fine and cfg.use_detail and cfg.match_window
            and cfg.thold_mode == "quantile"):
        fail(f"{CKPT_DETAIL} is not the s2d + window + quantile-detail model")
    reqs = [synthetic_pair(H, W, gen, DEV) for _ in range(n + 1)]

    def serve(left, right):
        return predict(model, left, right, *request_masks(left, right, cfg),
                       D)

    serve(reqs[0][0], reqs[0][1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spamat.moments.launches = 0
    kwarp.warp.launches = 0
    preds, lat = [], []
    for left, right, _, _ in reqs[1:]:
        t = time.perf_counter()
        preds.append(serve(left, right))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    launches = {"spamat_moments": spamat.moments.launches,
                "warp": kwarp.warp.launches}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for k, got in launches.items():
        if got != 3 * n:
            fail(f"serve_s2d: {k} launched {got} times in {n} requests, "
                 f"expected {3 * n}")
    for pred in preds:
        if pred.shape != (1, H, W) or not torch.isfinite(pred).all():
            fail(f"serve_s2d: prediction of shape {tuple(pred.shape)} not "
                 f"finite")
    model.use_kernels = False
    deltas = [(serve(left, right) - pred).abs().flatten()
              for pred, (left, right, _, _) in zip(preds, reqs[1:])]
    model.use_kernels = True
    if spamat.moments.launches != 3 * n or kwarp.warp.launches != 3 * n:
        fail("serve_s2d: the plain path launched a kernel")
    delta = torch.cat(deltas)
    mean_delta = float(delta.mean())
    if not mean_delta <= SERVE_MEAN_TOL:
        fail(f"serve_s2d kernel vs plain path: mean |delta disp| "
             f"{mean_delta:.4g} px > {SERVE_MEAN_TOL}")
    epes = [float((p - gt).abs()[valid].mean())
            for p, (_, _, gt, valid) in zip(preds, reqs[1:])]
    return {"latency_ms": lat, "launches": launches, "peak_mem_mb": peak_mb,
            "plain_mean_abs_delta_px": mean_delta,
            "plain_p999_abs_delta_px": float(torch.quantile(
                delta.float(), 0.999)),
            "epe_px": epes}


def eval_phase(torch, spamat, kwarp):
    """Each ANCHORS checkpoint evaluated by `cli.report_eval.report` at the
    JAX reports' protocol on its stream, held to its anchor's band; the
    faithful model's sparse branch must lower the final EPE.  Returns the
    reports with their verdicts and the launches of each run."""
    from decnet_tpu_torch.cli import report_eval
    out = {}
    for name, variant, anchor, anchor_abl, source in ANCHORS:
        spamat.moments.launches = 0
        kwarp.warp.launches = 0
        rep = report_eval.report(os.path.join(ROOT, "runs", name),
                                 **EVAL, variant=variant,
                                 device=DEV)
        launches = {"spamat_moments": spamat.moments.launches,
                    "warp": kwarp.warp.launches}
        epe, se = rep["stage3_epe"], rep["final_epe_se"]
        band = BAND_SE * se + BAND_REL * anchor
        ok = abs(epe - anchor) <= band
        rep.update(anchor_stage3_epe=anchor,
                   anchor_ablate_sparse_final_epe=anchor_abl,
                   anchor_source=source, band=band, in_band=ok,
                   launches=launches)
        print(f"  {name} ({variant}): " + " ".join(
            f"{k}={rep[k]:.5g}" for k in (
                "stage0_epe", "stage1_epe", "stage2_epe", "stage3_epe",
                "stage3_d1", "ablate_sparse_final_epe",
                "ablate_sparse_final_d1", "up0_baseline_epe",
                "up0_baseline_d1", "final_dense_epe", "final_dense_d1",
                "final_fusion_epe", "final_fusion_d1",
                "decomposition_win_epe", "sparse_contribution_epe",
                "final_epe_se", "seconds")), flush=True)
        print(f"  {name}: final EPE {epe:.5g} against the JAX anchor "
              f"{anchor} ({source}): |delta| {abs(epe - anchor):.4g}, band "
              f"{band:.4g} = {BAND_SE} x SE {se:.4g} + {BAND_REL} x "
              f"{anchor}: {'inside' if ok else 'OUTSIDE'}; launches "
              f"{json.dumps(launches)}", flush=True)
        want = 2 * 3 * rep["batches"]
        if any(n != want for n in launches.values()):
            fail(f"eval {name}: launches {launches}, expected {want} each")
        if not ok:
            fail(f"eval {name}: final EPE {epe:.5g} outside the band "
                 f"{anchor} +- {band:.4g}")
        if name == "ckpt_faithful" and not rep["sparse_contribution_epe"] > 0:
            fail(f"eval {name}: the sparse branch does not lower the final "
                 f"EPE (sparse_contribution_epe "
                 f"{rep['sparse_contribution_epe']:.4g})")
        out[name] = rep
    return out


@contextlib.contextmanager
def raw_scenes():
    """While installed, the synthetic streams' batches are their scenes
    before normalisation and masks: {"left", "right": (B,3,H,W) in
    [0, 255] f32, "gt": (B,H,W)}."""
    from decnet_tpu_torch.data import device_synth
    real = device_synth.finish_batch
    device_synth.finish_batch = lambda left, right, disp, *a: {
        "left": left, "right": right, "gt": disp.float()}
    try:
        yield device_synth
    finally:
        device_synth.finish_batch = real


def scene_arrays(torch, batch):
    """(B,H,W,7) numpy packs [left | right | gt] of a raw batch."""
    pack = torch.cat([batch["left"], batch["right"], batch["gt"][:, None]], 1)
    return pack.permute(0, 2, 3, 1).float().cpu().numpy()


def write_suites(torch, root):
    """The suites' files under `root` (see SF_SCENES): returns their
    dataset roots.  SceneFlow's packs are the eval phase's scenes: the
    same stream, seed and batches as `cli.report_eval.report` draws."""
    import pickle
    import numpy as np
    free = shutil.disk_usage(root).free
    if free < SUITE_BYTES:
        fail(f"datasets_eval: {root} has {free / 1e9:.2f} GB free, the "
             f"suites' files need {SUITE_BYTES / 1e9:.1f} GB")
    roots = {k: os.path.join(root, k) for k in (
        "sceneflow", "sceneflow_960", "kitti", "middlebury")}
    with raw_scenes() as ds:
        sf, cut = (os.path.join(roots[k], "test")
                   for k in ("sceneflow", "sceneflow_960"))
        os.makedirs(sf)
        os.makedirs(cut)
        stream = ds.device_batch_stream(
            EVAL["seed"], val=True, batch=EVAL["batch"], h=EVAL["h"],
            w=EVAL["w"], max_disp=EVAL["max_disp"], device=DEV,
            variant=ANCHORS[0][1])
        n = 0
        while n < SF_SCENES:
            for pack in scene_arrays(torch, next(stream)):
                np.save(os.path.join(sf, f"{n:04d}.npy"), pack)
                if n < SF_CUT_SCENES:
                    np.save(os.path.join(cut, f"{n:04d}.npy"),
                            np.ascontiguousarray(pack[:, SF_CUT:]))
                n += 1
        kt = os.path.join(roots["kitti"], "train")
        os.makedirs(kt)
        h, w = KITTI_SHAPE
        hp = -(-h // 27) * 27
        stream = ds.device_batch_stream(11, val=True, batch=1, h=hp, w=w,
                                        max_disp=216, device=DEV)
        for i in range(KITTI_SCENES):
            pack = scene_arrays(torch, next(stream))[0, hp - h:]
            obj = (pack[..., 6:] < 150).astype(np.float32)  # object mask
            np.save(os.path.join(kt, f"{i:06d}_10.npy"),
                    np.concatenate([pack, obj], -1))
        mb = os.path.join(roots["middlebury"], "MiddEval3H_processed",
                          "trainingH")
        os.makedirs(mb)
        h, w = MID_H_SHAPE
        for i, nd in enumerate(MID_H_NDISP):
            stream = ds.device_batch_stream(13 + i, val=True, batch=1, h=h,
                                            w=w, max_disp=-(-nd // 27) * 27,
                                            device=DEV)
            pack = scene_arrays(torch, next(stream))[0]
            with open(os.path.join(mb, f"Scene{nd}.pkl"), "wb") as f:
                pickle.dump({"ndisp": nd, "im0": pack[..., :3],
                             "im1": pack[..., 3:6],
                             "disparity": pack[..., 6]}, f)
    return roots


def count_launches(counters):
    return {k: c.launches for k, c in counters.items()}


def zero_launches(counters):
    for c in counters.values():
        c.launches = 0


def check_forward_launches(counters, forwards, where):
    """3 moments and 3 warps a forward, no backward kernel."""
    got = count_launches(counters)
    want = {k: 3 * forwards if k in ("spamat_moments", "warp") else 0
            for k in counters}
    if got != want:
        fail(f"{where}: launches {got} in {forwards} forwards, expected "
             f"{want}")
    return got


@contextlib.contextmanager
def recorded_submissions():
    """Each submission PNG the CLIs write: (path, disparity, ori_h,
    ori_w), recorded as `data.io.write_submission_png` is called."""
    from decnet_tpu_torch.data import io as dio
    real, seen = dio.write_submission_png, []

    def record(path, disp, ori_h=None, ori_w=None):
        seen.append((path, disp, ori_h, ori_w))
        return real(path, disp, ori_h, ori_w)
    dio.write_submission_png = record
    try:
        yield seen
    finally:
        dio.write_submission_png = real


def check_submissions(seen, where):
    """Each PNG, read back by the port's decoder, holds its disparity
    (cropped to ori_h x ori_w) within 1/256 px.  Returns the largest
    error."""
    import numpy as np
    from decnet_tpu_torch.data import io as dio
    worst = 0.0
    for path, disp, oh, ow in seen:
        want = np.asarray(disp, np.float32)
        if oh is not None:
            want = want[-oh:, -ow:]
        got = dio.read_png(path).astype(np.float32) / 256.0
        if got.shape != want.shape:
            fail(f"{where}: {path} is {got.shape}, the prediction "
                 f"{want.shape}")
        err = float(np.abs(got - np.clip(want, 0, 65535 / 256.0)).max())
        worst = max(worst, err)
        if not err <= SUBMISSION_TOL:
            fail(f"{where}: {path} is {err:.4g} px from its prediction")
    return worst


def kernel_vs_plain_batch(torch, model, ds, index, counters, where):
    """One sample of `ds` through the eval CLI's hand-off at its bucketed
    max_disp, kernel path against plain path: (mean |delta|, max_disp,
    the kernel path's launches)."""
    from decnet_tpu_torch.cli.eval import batch_max_disp
    from decnet_tpu_torch.data.loader import collate, to_device
    b = to_device(collate([ds[index]]), DEV)
    nd = batch_max_disp(b["n_disp"])
    args = (b["left"], b["right"], b["left_masks"], b["right_masks"])
    with torch.no_grad():
        zero_launches(counters)
        got = model(*args, max_disp=nd)["preds"][-1]
        launches = check_forward_launches(counters, 1, where)
        model.use_kernels = False
        want = model(*args, max_disp=nd)["preds"][-1]
        model.use_kernels = True
    if count_launches(counters) != launches:
        fail(f"{where}: the plain path launched a kernel")
    if not torch.isfinite(got).all():
        fail(f"{where}: non-finite prediction")
    delta = float((got - want).abs().mean())
    if not delta <= SERVE_MEAN_TOL:
        fail(f"{where} kernel vs plain path: mean |delta disp| {delta:.4g} "
             f"px > {SERVE_MEAN_TOL}")
    return delta, nd, launches


def stream_cli_epe(torch, model, batches):
    """Per batch, the mean over its samples of each sample's EPE over
    0 < gt < 192 (SceneFlow's ndisp, as `cli.eval` scores it) of `model`
    on the eval phase's stream batches."""
    import numpy as np
    from decnet_tpu_torch.cli.eval import batch_max_disp
    from decnet_tpu_torch.data.device_synth import device_batch_stream
    from decnet_tpu_torch.train.metrics import per_sample_epe_d1
    nd = batch_max_disp([SCENEFLOW_NDISP])
    stream = device_batch_stream(
        EVAL["seed"], val=True, batch=EVAL["batch"], h=EVAL["h"],
        w=EVAL["w"], max_disp=EVAL["max_disp"], dtype=model.cfg.torch_dtype,
        device=DEV, variant=SF_ANCHOR[1])
    out = []
    for _ in range(batches):
        b = next(stream)
        with torch.no_grad():
            pred = model(b["left"], b["right"], b["left_masks"],
                         b["right_masks"], max_disp=nd)["preds"][-1]
        epes, _ = per_sample_epe_d1(pred.float(), b["gt"],
                                    [SCENEFLOW_NDISP] * pred.shape[0])
        out.append(float(np.mean(epes)))
    return out


def datasets_eval_phase(torch, counters, roots, out_dir, faithful_epe):
    """`cli.eval` of ckpt_faithful on the SceneFlow packs (held to the
    faithful legacy anchor's band), on KITTI's train_eval split and on
    Middlebury-H's two ndisp (batch 1), with the launches a forward and the
    max_disp each batch chose; one batch of each of those two through the
    kernel path against the plain path; KITTI's submission PNGs read
    back; and one Middlebury-F forward (1998x2970, max_disp 810): its time
    and peak memory."""
    import numpy as np
    from decnet_tpu_torch.cli import eval as teval
    from decnet_tpu_torch.cli.demo import host_masks, predict
    from decnet_tpu_torch.data import get_dataset
    from decnet_tpu_torch.weights import load_checkpoint

    def run_eval(dataset, root, split, batch, *extra):
        zero_launches(counters)
        res = teval.main(["--dataset", dataset, "--root", root,
                          "--test_split", split, "--batch_size", str(batch),
                          "--resume", CKPT, "--num_workers", "4",
                          "--save2where", os.path.join(out_dir, dataset),
                          "--device", DEV, *extra])
        res["launches"] = check_forward_launches(
            counters, len(res["max_disp"]), f"datasets_eval {dataset}")
        return res

    out = {}
    model = load_checkpoint(CKPT, device=DEV)
    # SceneFlow: the like-for-like reading, and the anchor's band beside
    sf = run_eval("sceneflow", roots["sceneflow"], "test", SF_BATCH)
    name, variant, anchor, _, source = SF_ANCHOR
    per = sf["epe"]
    if len(per) != SF_SCENES // SF_BATCH:
        fail(f"datasets_eval sceneflow: {len(per)} batches")
    stream = stream_cli_epe(torch, model, len(per))
    se = float(np.std(per, ddof=1)) / math.sqrt(len(per))
    band = BAND_SE * se + BAND_REL * anchor
    epe = sf["mean_epe"]
    worst = max(abs(a - b) for a, b in zip(per, stream))
    ok = (abs(epe - np.mean(stream)) <= SF_STREAM_TOL
          and worst <= SF_BATCH_TOL)
    in_band = abs(epe - anchor) <= band
    sf.update(se=se, band=band, anchor=anchor, in_band=in_band,
              stream_epe=stream, stream_mean_epe=float(np.mean(stream)),
              max_batch_delta=worst, eval_phase_epe=faithful_epe,
              ms_per_batch=1e3 * float(np.mean(sf["seconds"][1:])))
    print(f"  sceneflow packs ({len(per)} batches of {SF_BATCH}, max_disp "
          f"{sorted(set(sf['max_disp']))}): mean EPE {epe:.5g}, loss_3 "
          f"{sf['mean_d1']:.4g}%, SE {se:.4g}; the same stream batches "
          f"scored alike {np.mean(stream):.5g} (|delta| "
          f"{abs(epe - np.mean(stream)):.4g}, tol {SF_STREAM_TOL}; largest "
          f"batch |delta| {worst:.4g}, tol {SF_BATCH_TOL}); the eval phase "
          f"read {faithful_epe:.5g} over gt < {EVAL['max_disp']} (delta "
          f"{epe - faithful_epe:+.4g}); the {name} {variant} anchor {anchor} "
          f"({source}): |delta| {abs(epe - anchor):.4g}, band {band:.4g}: "
          f"{'inside' if in_band else 'outside'}; {sf['ms_per_batch']:.2f} "
          f"ms a batch; launches {json.dumps(sf['launches'])}", flush=True)
    if not ok:
        fail(f"datasets_eval sceneflow: mean EPE {epe:.5g} against the "
             f"same stream batches' {np.mean(stream):.5g} (largest batch "
             f"delta {worst:.4g})")
    out["sceneflow"] = sf
    # the same scenes at SceneFlow's 540x960, padded back by the dataset
    cut = run_eval("sceneflow", roots["sceneflow_960"], "test", SF_BATCH)
    cut["ms_per_batch"] = 1e3 * float(np.mean(cut["seconds"][1:]))
    if not math.isfinite(cut["mean_epe"]):
        fail("datasets_eval sceneflow 540x960: non-finite EPE")
    print(f"  sceneflow 540x960 packs (the first {SF_CUT_SCENES} scenes, "
          f"12 zero columns padded back): mean EPE {cut['mean_epe']:.5g}, "
          f"loss_3 {cut['mean_d1']:.4g}% (the same scenes unpadded: "
          f"{np.mean(per[:len(cut['epe'])]):.5g}); "
          f"{cut['ms_per_batch']:.2f} ms a batch", flush=True)
    out["sceneflow_960"] = cut

    for suite, dataset, split in (("kitti", "kitti15", "train_eval"),
                                  ("middlebury", "middlebury", "eval_H")):
        res = run_eval(dataset, roots[suite], split, 1)
        ds = get_dataset(dataset, roots[suite], split=split,
                         is_training=False)
        deltas = [kernel_vs_plain_batch(torch, model, ds, i, counters,
                                        f"datasets_eval {suite}")[0]
                  for i in (range(len(ds)) if suite == "middlebury"
                            else range(1))]
        res.update(plain_mean_abs_delta_px=deltas,
                   ms_per_batch=1e3 * float(np.mean(res["seconds"][1:])))
        print(f"  {suite} ({len(res['epe'])} batches of 1): max_disp "
              f"{res['max_disp']}, mean EPE {res['mean_epe']:.5g}, loss_3 "
              f"{res['mean_d1']:.4g}%, {res['ms_per_batch']:.2f} ms a "
              f"batch, launches {json.dumps(res['launches'])}; kernel vs "
              f"plain mean |delta disp| "
              + ", ".join(f"{d:.4g}" for d in deltas) + " px", flush=True)
        out[suite] = res
    if sorted(set(out["middlebury"]["max_disp"])) != sorted(
            -(-nd // 27) * 27 for nd in MID_H_NDISP):
        fail(f"datasets_eval middlebury: max_disp "
             f"{out['middlebury']['max_disp']}")
    # KITTI's submission PNGs, each against the prediction written
    with recorded_submissions() as seen:
        run_eval("kitti15", roots["kitti"], "train_eval", 1, "--is_eval",
                 "0")
    if len(seen) != KITTI_SCENES:
        fail(f"datasets_eval: {len(seen)} submission PNGs written")
    out["kitti"]["submission_max_err_px"] = check_submissions(
        seen, "datasets_eval kitti submission")
    print(f"  kitti submission: {len(seen)} PNGs of "
          f"{KITTI_SHAPE[0]}x{KITTI_SHAPE[1]}, read back within "
          f"{out['kitti']['submission_max_err_px']:.4g} px", flush=True)
    # Middlebury-F: one forward at full size, its time and peak memory
    h, w = MID_F_SHAPE
    with raw_scenes() as ds:
        b = next(ds.device_batch_stream(17, val=True, batch=1, h=h, w=w,
                                        max_disp=MID_F_NDISP, device=DEV))
    left, right = b["left"] / 255.0, b["right"] / 255.0
    masks = host_masks(left, right, model.cfg)
    predict(model, left, right, *masks, MID_F_NDISP)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(counters)
    t = time.perf_counter()
    pred = predict(model, left, right, *masks, MID_F_NDISP)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = check_forward_launches(counters, 1, "datasets_eval "
                                      "middlebury_f")
    if pred.shape != (1, h, w) or not torch.isfinite(pred).all():
        fail(f"middlebury_f: prediction {tuple(pred.shape)} not finite")
    valid = (b["gt"] > 0) & (b["gt"] < MID_F_NDISP)
    out["middlebury_f"] = {
        "ms": ms, "peak_mem_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
        "launches": launches, "epe_px": float((pred - b["gt"]).abs()[
            valid].mean())}
    print(f"  middlebury_f {h}x{w} max_disp {MID_F_NDISP}: "
          f"{ms:.2f} ms, peak {out['middlebury_f']['peak_mem_mb']:.1f} MiB, "
          f"EPE {out['middlebury_f']['epe_px']:.4g} px, launches "
          f"{json.dumps(launches)}", flush=True)
    del model
    torch.cuda.empty_cache()
    return out


def datasets_train_phase(torch, spamat, counters, roots):
    """The faithful recipe trained from the SceneFlow packs through the
    train CLI's entry (`prepare` with data.on_device=false, batch 8 of
    162x486 crops, mask_source compute, 4 loader threads; warm-started
    from the checkpoint): a warm-up step, TRAIN_DISK_STEPS timed steps
    with their launches and the host's wait for each batch, then the
    kernel vs plain step check with the planted faults on one batch from
    disk.  Then `cli.train.main` 2 steps each on KITTI (its augment
    schedule, B = 8 of 270x513) and on the host synthetic dataset."""
    import numpy as np
    from decnet_tpu_torch.cli import train as tcli

    base = ["--config", os.path.join(CKPT, "config.json"), "--set",
            "data.on_device=false", "--set", "data.num_workers=4",
            "--init_from", CKPT, "--device", DEV]
    ckpt_out = os.path.join(ROOT, "build", "decnet_tpu_torch",
                            "smoke_ckpt_disk")
    shutil.rmtree(ckpt_out, ignore_errors=True)
    run = tcli.prepare(base + ["--dataset", "sceneflow", "--root",
                               roots["sceneflow_960"], "--train_split", "test",
                               "--mask_source", "compute", "--steps",
                               str(TRAIN_DISK_STEPS + 1), "--ckpt_dir",
                               ckpt_out])
    cfg, model = run.cfg, run.state.model
    shape = (cfg.train.batch_size, cfg.train.crop_h, cfg.train.crop_w,
             cfg.model.max_disp, cfg.model.dtype)
    if shape != TRAIN_SHAPE or cfg.data.on_device:
        fail(f"datasets_train config {shape} is not the faithful run's")
    run.step(next(run.stream))                      # warm-up, rate 0
    torch.cuda.synchronize()
    zero_launches(counters)
    ms, waits, losses, batch = [], [], [], None
    for _ in range(TRAIN_DISK_STEPS):
        t = time.perf_counter()
        batch = next(run.stream)
        waits.append((time.perf_counter() - t) * 1e3)
        logs = run.step(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(logs["total"]))
        if not all(math.isfinite(float(v)) for v in logs.values()):
            fail("datasets_train: non-finite logs")
    launches = count_launches(counters)
    if any(n != 3 * TRAIN_DISK_STEPS for n in launches.values()):
        fail(f"datasets_train: launches {launches} in {TRAIN_DISK_STEPS} "
             f"steps, expected 3 each a step")
    share = sum(waits) / sum(ms)
    for i, (m, w, l) in enumerate(zip(ms, waits, losses)):
        print(f"  step {i + 2}: {m:.2f} ms, loader wait {w:.2f} ms, "
              f"loss={l:.5f}", flush=True)
    checks = step_checks(torch, spamat, model, batch, cfg, "datasets_train")
    del run, model
    shutil.rmtree(ckpt_out, ignore_errors=True)
    torch.cuda.empty_cache()
    others = {}
    for dataset, extra in (
            ("kitti15", ["--root", roots["kitti"], "--train_split", "train",
                         "--set", f"train.crop_h={KITTI_CROP[0]}", "--set",
                         f"train.crop_w={KITTI_CROP[1]}"]),
            ("synthetic", ["--dataset_length", "16"])):
        zero_launches(counters)
        t = time.perf_counter()
        tcli.main(base + ["--dataset", dataset, "--steps", "2", "--set",
                          "train.log_every=1", "--ckpt_dir", ckpt_out]
                  + extra)
        torch.cuda.synchronize()
        n = count_launches(counters)
        if any(v != 6 for v in n.values()):
            fail(f"datasets_train {dataset}: launches {n} in 2 steps")
        others[dataset] = {"seconds": time.perf_counter() - t,
                           "launches": n}
        shutil.rmtree(ckpt_out, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"step_ms": ms, "loader_wait_ms": waits,
            "loader_wait_share": share, "losses": losses,
            "launches": launches, "others": others, **checks}


def reference_state_dict(params_npz):
    """The reference-form state dict of a `params.npz`: every name of the
    port's name map whose flax array the file holds, in the torch layout
    (each layout conversion inverted)."""
    import numpy as np
    from decnet_tpu_torch.train import torch_import as ti
    to_torch = {ti.conv2d_kernel: lambda k: k.transpose(3, 2, 0, 1),
                ti.conv3d_kernel: lambda k: k.transpose(4, 3, 0, 1, 2),
                ti.conv_transpose2d_kernel:
                    lambda k: k[::-1, ::-1].transpose(2, 3, 0, 1)}
    with np.load(params_npz) as z:
        flat = {tuple(p[2:-2] for p in k.split("/")): z[k] for k in z.files}
    state = {}
    for tname, fpath, conv, coll in ti.build_name_map(4):
        key = (coll,) + tuple(fpath)
        if key in flat:
            v = flat[key]
            state[tname] = np.array(
                to_torch[conv](v) if conv is not None else v, np.float32,
                order="C")
    return state, len(flat)


def reference_import_phase(torch, gen, tmp):
    """ckpt_faithful in the reference's form (`module.` names under
    `model_state`, torch.save'd), served through the CLIs' `--resume
    x.pkl` (`cli.common`): the import must copy every array with nothing
    missing or unmatched, and one 540x972 request must give the same
    disparities, bit for bit, as `load_checkpoint(ckpt_faithful)`."""
    import argparse
    import io
    from decnet_tpu_torch.cli import common
    from decnet_tpu_torch.cli.demo import host_masks, predict
    from decnet_tpu_torch.data.synthetic import synthetic_pair
    from decnet_tpu_torch.weights import load_checkpoint
    state, n_npz = reference_state_dict(os.path.join(CKPT, "params.npz"))
    pkl = os.path.join(tmp, "ckpt_faithful_reference.pkl")
    torch.save({"model_state": {"module." + k: torch.from_numpy(v)
                                for k, v in state.items()}}, pkl)
    p = argparse.ArgumentParser()
    common.add_config_args(p)
    args = p.parse_args(["--config", os.path.join(CKPT, "config.json"),
                         "--resume", pkl, "--device", DEV])
    cfg = common.apply_checkpoint_sidecar(common.build_config(args), args)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        model, _ = common.init_model_and_state(cfg, args.resume,
                                               device=args.device)
    report = printed.getvalue().strip()
    print(f"  {report}", flush=True)
    want_report = (f"copied {len(state)}, missing 0, unmatched 0")
    if not report.endswith(want_report) or len(state) != n_npz:
        fail(f"reference_import: '{report}', expected '{want_report}' with "
             f"all {n_npz} arrays of params.npz")
    ref = load_checkpoint(CKPT, device=DEV)
    H, W, D = SERVE
    left, right, _, _ = synthetic_pair(H, W, gen, DEV)
    masks = host_masks(left, right, ref.cfg)
    got = predict(model, left, right, *masks, D)
    want = predict(ref, left, right, *masks, D)
    if not torch.equal(got, want):
        fail(f"reference_import: the .pkl's disparities differ from the "
             f"checkpoint's by up to {float((got - want).abs().max()):.3g}")
    del model, ref
    torch.cuda.empty_cache()
    return {"arrays": len(state), "report": report, "bit_equal": True}


def demo_cli_phase(torch, counters, sf_root, tmp):
    """Two SceneFlow scenes written as im0.png / im1.png / calib.txt by
    the port's encoder, then `cli.demo.main` on the card with each mask
    source: every submission PNG read back within 1/256 px of `predict`'s
    output, 3 moments and 3 warps a scene."""
    import numpy as np
    from decnet_tpu_torch.cli import demo
    from decnet_tpu_torch.data import io as dio
    scenes = os.path.join(tmp, "demo_in")
    for i in range(2):
        pack = np.load(os.path.join(sf_root, "test", f"{i:04d}.npy"))
        sdir = os.path.join(scenes, f"scene{i}")
        os.makedirs(sdir)
        for name, img in (("im0.png", pack[..., :3]),
                          ("im1.png", pack[..., 3:6])):
            dio.write_png(os.path.join(sdir, name),
                          np.round(img).astype(np.uint8))
        with open(os.path.join(sdir, "calib.txt"), "w") as f:
            f.write(f"width={pack.shape[1]}\nndisp={SERVE[2]}\n")
    out, real = {}, demo.predict
    for source in ("compute", "wavelet"):
        preds = []

        def spy(*a, **k):
            preds.append(real(*a, **k))
            return preds[-1]
        demo.predict = spy
        zero_launches(counters)
        save = os.path.join(tmp, f"demo_{source}")
        try:
            demo.main(["--root", scenes, "--save2where", save, "--resume",
                       CKPT, "--mask_source", source, "--device", DEV])
        finally:
            demo.predict = real
        launches = check_forward_launches(counters, 2, f"demo_cli {source}")
        seen = [(os.path.join(save, f"scene{i}.png"),
                 p[0].float().cpu().numpy(), None, None)
                for i, p in enumerate(preds)]
        if len(seen) != 2:
            fail(f"demo_cli {source}: {len(seen)} predictions")
        out[source] = {"max_err_px": check_submissions(
            seen, f"demo_cli {source}"), "launches": launches}
    return out


# the bench's batch (cli/bench.py: B = 4 of 540x972, bf16) and the
# flagship configuration of __graft_entry__.py:20-41, rebuilt here
BENCH_B = 4
FLAGSHIP = dict(max_disp=216, base_channels=8, num_stage=4, down_scale=3,
                cost_func="cor", use_detail=True, thold=0.9,
                dtype="bfloat16", s2d_fine=True, s2d_stages=2,
                match_window=12, cand_fallback=True, thold_mode="quantile",
                detail_density=0.25)
#   the flagship is served on fresh weights from --seed: an untrained
#   detail head's logits saturate the sigmoid, where the strict quantile
#   cut keeps no pixel, so its last kernel is scaled by this factor (as the
#   CPU tests do) to give the masks their target density
FLAGSHIP_HEAD_SCALE = 0.05
EXEC_S2D_EPE_TOL = 0.02   # px, cli.eval mean EPE with and without --exec_s2d
#   ckpt_faithful in bf16, the packed form's mean |delta| from the f32
#   faithful answer over the faithful bf16 form's: a wrong packed head
#   moves the packed form away from the answer, bf16 moves both alike
CKPT_BF16_RATIO = 1.25
PACKED_STEPS = 3          # timed frozen-BN steps, each form, after a warm-up
#   packed_exec step vs faithful step, per leaf of the faithful parameters:
#   |g_packed - g_faithful| / (|g_faithful| + PACKED_LEAF_FLOOR |G|), G the
#   whole faithful gradient, of the worst leaf.  A leaf the packed graph
#   fails to reach reads ~1; the floor keeps a leaf whose gradient is
#   ~0 by construction (a bias a softmax cancels) at bf16's noise over |G|
#   Sound run (NVIDIA H100 80GB HBM3, B=8 of 162x486, bf16): 0.1421;
#   refine_1's kernels cut from the gradient: 0.9978.  0.4 sits near the
#   geometric middle.
PACKED_LEAF_RTOL = 0.4
PACKED_LEAF_FLOOR = 1e-3
PACKED_FAULT_HEADS = ("refine_1", "soft_att_1")   # stage 2's packed heads


def bench_phase(torch, counters):
    """`cli.bench.main` at its full size (B = 4 of 540x972, bf16, the s2d,
    faithful and faithful_nhwc variants), its JSON line printed; each
    variant's 3 moments and 3 warps a forward; then the faithful variant
    (the faithful weights repacked to s2d_stages 2) against faithful_nhwc
    (the same weights in faithful form), each the prediction of the model
    the bench timed on the bench's inputs; and the same repack of
    ckpt_faithful's trained weights (`s2d_exec_model`, stages 2) against
    the checkpoint in faithful form on those inputs, in f32 (mean |delta|
    of the final disparity) and in bf16 (each form's mean |delta| from
    the f32 faithful answer, the packed form's no more than
    CKPT_BF16_RATIO times the faithful form's)."""
    from decnet_tpu_torch.cli import bench
    from decnet_tpu_torch.models.repack import s2d_exec_model
    from decnet_tpu_torch.weights import load_checkpoint
    zero_launches(counters)
    result = bench.main([])
    launches = count_launches(counters)
    rec = result["record"]
    kind = torch.cuda.get_device_name(0)
    if "backend=cuda" not in rec["unit"] or kind not in rec["unit"]:
        fail(f"bench: unit {rec['unit']!r} does not name the card")
    for mode, r in result["variants"].items():
        for k in ("spamat_moments", "warp"):
            if r["launches"][k] != 3 * r["forwards"]:
                fail(f"bench {mode}: {k} launched {r['launches'][k]} times "
                     f"in {r['forwards']} timed forwards")
        print(f"  {mode}: {r['pairs_per_sec']:.3f} pairs/s (rounds "
              + ", ".join(f"{x:.3f}" for x in r["rounds_pairs_per_sec"])
              + f"), peak {r['peak_mem_mb']} MiB, "
              f"{r['flops_per_pair'] / 1e9:.2f} GFLOP a pair counted",
              flush=True)

    def held(where, packed, faithful):
        delta = (packed - faithful).abs()
        mean_delta = float(delta.mean())
        if not torch.isfinite(packed).all():
            fail(f"bench {where}: non-finite disparity")
        print(f"  {where} (repacked, s2d_stages 2) vs faithful form: mean "
              f"|delta disp| {mean_delta:.5g} px, max "
              f"{float(delta.max()):.4g}", flush=True)
        if not mean_delta <= SERVE_MEAN_TOL:
            fail(f"bench {where}: repacked vs faithful form mean |delta "
                 f"disp| {mean_delta:.4g} px > {SERVE_MEAN_TOL}")
        return mean_delta

    v = result["variants"]
    fresh = held("faithful", v["faithful"]["pred"],
                 v["faithful_nhwc"]["pred"])
    inputs = bench.make_inputs(bench.CARD["H"], bench.CARD["W"],
                               bench.CARD["batch"], DEV)[:4]
    preds = {}
    for dtype in ("float32", "bfloat16"):
        model = load_checkpoint(CKPT, device=DEV, dtype=dtype)
        for form, m in (("faithful", model),
                        ("packed", s2d_exec_model(model, stages=2))):
            if m.cfg.s2d_stages != (2 if form == "packed" else 1):
                fail(f"bench ckpt_faithful {form}: s2d_stages "
                     f"{m.cfg.s2d_stages}")
            with torch.inference_mode():
                preds[dtype, form] = m(*inputs)["preds"][-1].float()
            del m
        del model
    # in f32 the repack is exact up to summation order: the trained
    # weights' packed heads held like the fresh ones
    trained = held("ckpt_faithful f32", preds["float32", "packed"],
                   preds["float32", "faithful"])
    # in bf16 (the checkpoint's dtype) each form rounds its own sums and
    # stage 3's candidates follow stage 2's rounded disparity, so the two
    # forms part by about bf16's own error: each is held against the f32
    # answer, the packed form no further from it than CKPT_BF16_RATIO
    # times the faithful form
    exact = preds["float32", "faithful"]
    dist = {form: float((preds["bfloat16", form] - exact).abs().mean())
            for form in ("faithful", "packed")}
    between = float((preds["bfloat16", "packed"]
                     - preds["bfloat16", "faithful"]).abs().mean())
    ratio = dist["packed"] / dist["faithful"]
    print(f"  ckpt_faithful bf16: mean |delta disp| from the f32 answer, "
          f"faithful form {dist['faithful']:.5g} px, packed "
          f"{dist['packed']:.5g} (ratio {ratio:.4g}, tol "
          f"{CKPT_BF16_RATIO}); between the forms {between:.5g}",
          flush=True)
    if not (torch.isfinite(preds["bfloat16", "packed"]).all()
            and ratio <= CKPT_BF16_RATIO):
        fail(f"bench ckpt_faithful bf16: the packed form is {ratio:.4g}x "
             f"the faithful form's distance from the f32 answer")
    del preds, exact
    torch.cuda.empty_cache()
    return {"record": rec, "launches": launches,
            "faithful_vs_nhwc_mean_abs_delta_px": fresh,
            "ckpt_faithful_packed_mean_abs_delta_px": trained,
            "ckpt_faithful_bf16": dict(dist, between=between, ratio=ratio),
            "variants": {m: {k: x for k, x in r.items() if k != "pred"}
                         for m, r in v.items()}}


def serve_flagship_phase(torch, counters, gen):
    """__graft_entry__.py's flagship configuration from the port's
    ModelConfig (s2d_stages 2, learned quantile detail masks, window 12,
    cand_fallback) on fresh seeded weights: one 540x972 request through
    `cli.demo.predict` after a warm-up, its latency and launches, and the
    kernel path against the plain path."""
    from decnet_tpu_torch.cli.demo import predict
    from decnet_tpu_torch.config import ModelConfig
    from decnet_tpu_torch.data import io as dio
    from decnet_tpu_torch.data.synthetic import synthetic_pair
    from decnet_tpu_torch.models import DecNet
    from decnet_tpu_torch.nn.heads import RefinementS2D
    torch.manual_seed(int(gen.initial_seed()))
    model = DecNet(ModelConfig(**FLAGSHIP))
    if not isinstance(model.refine_1, RefinementS2D):
        fail("serve_flagship: stage 2 is not packed")
    with torch.no_grad():
        for name, m in model.named_children():
            if name.startswith("detail_"):
                m.head1.conv.weight.mul_(FLAGSHIP_HEAD_SCALE)
    model = model.to(DEV).eval()
    H, W, D = SERVE
    warm, (left, right, gt, valid) = [synthetic_pair(H, W, gen, DEV)
                                      for _ in range(2)]
    predict(model, warm[0], warm[1], None, None, D)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(counters)
    t = time.perf_counter()
    pred = predict(model, left, right, None, None, D)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = check_forward_launches(counters, 1, "serve_flagship")
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    if pred.shape != (1, H, W) or not torch.isfinite(pred).all():
        fail(f"serve_flagship: prediction {tuple(pred.shape)} not finite")
    model.use_kernels = False
    plain = predict(model, left, right, None, None, D)
    with torch.no_grad():
        lp, rp = (dio.normalize_image(x) for x in (left, right))
        density = [float(m.mean()) for m in
                   model(lp, rp)["masks_used"]]
    model.use_kernels = True
    if count_launches(counters) != launches:
        fail("serve_flagship: the plain path launched a kernel")
    delta = (plain - pred).abs()
    mean_delta = float(delta.mean())
    epe = float((pred - gt).abs()[valid].mean())
    print(f"  flagship request {ms:.3f} ms, peak {peak_mb:.1f} MiB, mask "
          f"density " + ", ".join(f"{d:.3f}" for d in density)
          + f"; kernel vs plain mean |delta disp| {mean_delta:.5g} px; EPE "
          f"of fresh weights {epe:.4f}", flush=True)
    if not mean_delta <= SERVE_MEAN_TOL:
        fail(f"serve_flagship kernel vs plain path: mean |delta disp| "
             f"{mean_delta:.4g} px > {SERVE_MEAN_TOL}")
    del model
    torch.cuda.empty_cache()
    return {"latency_ms": ms, "peak_mem_mb": peak_mb, "launches": launches,
            "mask_density": density, "plain_mean_abs_delta_px": mean_delta,
            "epe_px": epe}


def exec_s2d_phase(torch, spamat, counters, roots, out_dir, plain_epe):
    """`cli.eval --exec_s2d 1` of ckpt_faithful on the SceneFlow packs (its
    s2d twin, s2d_stages 1, as JAX's CLI runs it) against the same run
    without it; then `train.packed_exec`: the train CLI's frozen-BN step
    of the faithful recipe through its packed twin (s2d_stages 2) against
    the faithful frozen-BN step on one batch (loss, gradient cosine, the
    worst leaf's relative gradient error), which must reject a packed
    step with one stage-2 head's kernels cut from the gradient
    (PACKED_FAULT_HEADS); and a few timed
    steps of each form with their launches."""
    from decnet_tpu_torch.cli import eval as teval
    from decnet_tpu_torch.cli import train as tcli
    from decnet_tpu_torch.train.step import loss_and_grads, train_step
    zero_launches(counters)
    res = teval.main(["--dataset", "sceneflow", "--root", roots["sceneflow"],
                      "--test_split", "test", "--batch_size", str(SF_BATCH),
                      "--resume", CKPT, "--num_workers", "4", "--exec_s2d",
                      "1", "--save2where", os.path.join(out_dir, "exec_s2d"),
                      "--device", DEV])
    eval_launches = check_forward_launches(counters, len(res["max_disp"]),
                                           "exec_s2d eval")
    eval_delta = abs(res["mean_epe"] - plain_epe)
    print(f"  cli.eval --exec_s2d 1: mean EPE {res['mean_epe']:.5g} against "
          f"{plain_epe:.5g} without (|delta| {eval_delta:.4g}, tol "
          f"{EXEC_S2D_EPE_TOL}); launches {json.dumps(eval_launches)}",
          flush=True)
    if not eval_delta <= EXEC_S2D_EPE_TOL:
        fail(f"exec_s2d: EPE {res['mean_epe']:.5g} vs {plain_epe:.5g}")

    ckpt_out = os.path.join(ROOT, "build", "decnet_tpu_torch",
                            "smoke_ckpt_packed")
    run = tcli.prepare(["--config", os.path.join(CKPT, "config.json"),
                        "--dataset", "synthetic", "--init_from", CKPT,
                        "--ckpt_dir", ckpt_out, "--device", DEV, "--set",
                        "train.packed_exec=1", "--set", "train.freeze_bn=1"])
    cfg, model = run.cfg, run.state.model
    if run.packed is None or not run.freeze_bn():
        fail("packed_exec: the run has no packed frozen step")
    b = next(run.stream)
    names = [n for n, _ in model.named_parameters()]

    def step(packed):
        lg, grads = loss_and_grads(model, b, cfg, True, packed)
        return float(lg["total"]), [g.detach().float().clone()
                                    for g in grads]

    def against(lk, gk, lf, gf):
        """(loss relative error, whole-gradient cosine, the worst leaf's
        |g - g_faithful| / (|g_faithful| + PACKED_LEAF_FLOOR |G_faithful|)
        and its name), and the leaves' readings, worst first."""
        whole = float(torch.cat([y.flatten() for y in gf]).double().norm())
        leaves = []
        for n, x, y in zip(names, gk, gf):
            ny, nd = float(y.double().norm()), float((x - y).double().norm())
            leaves.append((nd / (ny + PACKED_LEAF_FLOOR * whole), n,
                           ny / whole, nd / whole))
        leaves.sort(reverse=True)
        cos = float(torch.nn.functional.cosine_similarity(
            torch.cat([x.flatten() for x in gk]).double(),
            torch.cat([y.flatten() for y in gf]).double(), dim=0))
        return (abs(lk - lf) / abs(lf), cos, leaves[0][0], leaves[0][1],
                leaves)

    def show(leaves, k=6):
        return "; ".join(f"{n} {r:.4g} (|g| {g:.3g}, |d| {d:.3g} of |G|)"
                         for r, n, g, d in leaves[:k])

    def accepted(rel, cos, worst, lk):
        return (math.isfinite(lk) and rel <= TRAIN_LOSS_RTOL
                and cos >= TRAIN_GRAD_COS and worst <= PACKED_LEAF_RTOL)

    lf, gf = step(None)
    # the faithful step again: cuDNN's run-to-run order
    floor = against(*step(None), lf, gf)
    lp, gp = step(run.packed)
    rel, cos, worst, leaf, leaves = against(lp, gp, lf, gf)
    print(f"  packed_exec frozen-BN step vs faithful frozen-BN step: loss "
          f"{lp:.6g} vs {lf:.6g} (rel {rel:.4g}), gradient cosine "
          f"{cos:.7g}, worst leaf {leaf} {worst:.4g} (tol "
          f"{PACKED_LEAF_RTOL}); faithful step twice: worst leaf {floor[3]} "
          f"{floor[2]:.4g}\n    worst leaves: {show(leaves)}", flush=True)
    if not accepted(rel, cos, worst, lp):
        fail(f"packed_exec: loss rel {rel:.3e}, gradient cosine {cos:.6f}, "
             f"worst leaf {leaf} {worst:.4g}")
    # planted faults: one stage-2 head's kernels in the packed twin cut
    # from the gather's graph (their values kept), so the forward and the
    # loss are the sound ones and only that head's faithful leaves lose
    # their gradient; the check must reject each.  refine_1 carries ~half
    # of |G|, soft_att_1 under one per cent, which the whole-gradient cosine
    # alone would not see
    twin, apply_fn = run.packed
    faults = {}
    for head in PACKED_FAULT_HEADS:
        cut = {k for k, t in twin.state_dict().items()
               if k.startswith(head + ".") and t.dim() == 4}
        if not cut:
            fail(f"packed_exec: the twin has no {head} kernels")
        planted = (twin, lambda m, cut=cut: {
            k: v.detach() if k in cut else v for k, v in apply_fn(m).items()})
        lx, gx = step(planted)
        f_rel, f_cos, f_worst, f_leaf, f_leaves = against(lx, gx, lf, gf)
        del gx
        rejected = not accepted(f_rel, f_cos, f_worst, lx)
        faults[head] = {"loss_rel": f_rel, "grad_cos": f_cos,
                        "worst_leaf": (f_leaf, f_worst),
                        "rejected": rejected}
        print(f"  packed_exec planted fault ({head}'s {len(cut)} kernels "
              f"without gradient): loss rel {f_rel:.4g}, gradient cosine "
              f"{f_cos:.7g}, worst leaf {f_leaf} {f_worst:.4g} -> "
              f"{'rejected' if rejected else 'passed'}\n    worst leaves: "
              f"{show(f_leaves, 3)}", flush=True)
        if not rejected:
            fail(f"packed_exec: the check passed with {head}'s kernels cut "
                 f"from the gradient")
    del gf, gp
    batches = [next(run.stream) for _ in range(PACKED_STEPS + 1)]
    times, launches = {}, {}
    for form, packed in (("faithful", None), ("packed", run.packed)):
        train_step(run.state, batches[0], cfg, True, packed)
        torch.cuda.synchronize()
        zero_launches(counters)
        ms = []
        for bb in batches[1:]:
            t = time.perf_counter()
            logs = train_step(run.state, bb, cfg, True, packed)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            if not math.isfinite(float(logs["total"])):
                fail(f"packed_exec {form} step: non-finite loss")
        launches[form] = count_launches(counters)
        if any(n != 3 * PACKED_STEPS for n in launches[form].values()):
            fail(f"packed_exec {form}: launches {launches[form]} in "
                 f"{PACKED_STEPS} steps")
        times[form] = ms
        print(f"  frozen-BN steps, {form}: "
              + ", ".join(f"{x:.2f}" for x in ms) + " ms, launches "
              + json.dumps(launches[form]), flush=True)
    del run
    torch.cuda.empty_cache()
    return {"eval": {k: res[k] for k in ("mean_epe", "mean_d1", "epe",
                                         "max_disp")},
            "eval_plain_epe": plain_epe, "eval_abs_delta": eval_delta,
            "eval_launches": eval_launches, "loss_rel": rel,
            "grad_cos": cos, "worst_leaf": (leaf, worst),
            "faithful_twice_worst_leaf": (floor[3], floor[2]),
            "worst_leaves": leaves[:6],
            "planted_faults": faults,
            "step_ms": times, "launches": launches}


# The DrivingStereo fixture (tests/fixtures/drivingstereo): three 400x881
# scenes, JPEG views written by cv2, and the manifest of their decodes'
# SHA-256s and of the JAX CLI's EPE on them (ckpt_faithful, bf16, CPU).
# `cli.eval` on the card must read that EPE within DS_EPE_TOL px.
DS_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "drivingstereo")
DS_EPE_TOL = 0.05
JPEG_REPEATS = 5          # decodes of each fixture image timed
# the model configurations beyond the faithful one, each the faithful
# recipe (runs/ckpt_faithful/config.json: base_channels 8, max_disp 216,
# bf16) with one knob changed, on fresh weights from train.seed
KNOB_WIDTH = (8, 216)     # base_channels, max_disp
KNOBS = {"cost_func=cat": {"cost_func": "cat"},
         "cost_func=ssd": {"cost_func": "ssd"},
         "norm=gn": {"norm": "gn"},
         "num_stage=3": {"num_stage": 3},
         "num_stage=2": {"num_stage": 2},
         "num_stage=1": {"num_stage": 1}}
# the reference's Middlebury full-resolution setting: stage 3 upsamples
# stage 2's prediction bicubically and runs no head
SKIP_STAGE = 3
# standalone SpaMat / SpaVar, kernel path vs plain path: both accumulate
# the same f32 products (from the same bf16 features in bf16) in other
# orders, so each output moves by a few f32 ulps: max |kernel - plain| /
# max |plain| <= 1e-4, as the f32 backward's bound
STANDALONE_OUT_TOL = 1e-4


def jpeg_files_phase():
    """Every JPEG of the DrivingStereo fixture decoded on this host by the
    port's decoder (`data/io.py::read_image`), its SHA-256 against the
    manifest's of cv2's decode, and the ms an image."""
    import hashlib
    from decnet_tpu_torch.data import io as dio
    with open(os.path.join(DS_FIXTURE, "manifest.json")) as f:
        manifest = json.load(f)
    ms = []
    for rel, want in sorted(manifest["rgb_sha256"].items()):
        path = os.path.join(DS_FIXTURE, "test", rel)
        img = dio.read_image(path)
        got = hashlib.sha256(img.tobytes()).hexdigest()
        if img.shape != tuple(manifest["size"]) + (3,) or got != want:
            fail(f"jpeg_files: {rel} decodes to {img.shape} sha256 {got}, "
                 f"the manifest says {want}")
        for _ in range(JPEG_REPEATS):
            t = time.perf_counter()
            dio.read_image(path)
            ms.append((time.perf_counter() - t) * 1e3)
    print(f"  {len(manifest['rgb_sha256'])} JPEGs of "
          f"{manifest['size'][0]}x{manifest['size'][1]}: every SHA-256 "
          f"equal to cv2's; {sum(ms) / len(ms):.3f} ms an image (min "
          f"{min(ms):.3f}, max {max(ms):.3f}, {len(ms)} decodes)",
          flush=True)
    return {"images": len(manifest["rgb_sha256"]), "ms": ms,
            "mean_ms": sum(ms) / len(ms), "manifest": manifest}


def drivingstereo_eval_phase(torch, counters, out_dir, manifest):
    """`cli.eval --dataset drivingstereo` of ckpt_faithful on the fixture
    tree (batch 1, bf16): its EPE against the manifest's JAX EPE, the
    launches (3 moments and 3 warps a forward), and each scene through the
    kernel path against the plain path."""
    import numpy as np
    from decnet_tpu_torch.cli import eval as teval
    from decnet_tpu_torch.data import get_dataset
    from decnet_tpu_torch.weights import load_checkpoint
    zero_launches(counters)
    res = teval.main(["--dataset", "drivingstereo", "--root", DS_FIXTURE,
                      "--test_split", "test", "--batch_size", "1",
                      "--resume", CKPT, "--num_workers", "4",
                      "--save2where", out_dir, "--device", DEV])
    res["launches"] = check_forward_launches(
        counters, len(res["max_disp"]), "drivingstereo_eval")
    want = manifest["jax_eval"]
    delta = abs(res["mean_epe"] - want["mean_epe"])
    model = load_checkpoint(CKPT, device=DEV)
    ds = get_dataset("drivingstereo", DS_FIXTURE, split="test",
                     is_training=False)
    deltas = [kernel_vs_plain_batch(torch, model, ds, i, counters,
                                    "drivingstereo_eval")[0]
              for i in range(len(ds))]
    del model
    torch.cuda.empty_cache()
    res.update(jax_mean_epe=want["mean_epe"], epe_delta=delta,
               plain_mean_abs_delta_px=deltas,
               ms_per_batch=1e3 * float(np.mean(res["seconds"][1:])))
    print(f"  drivingstereo ({len(res['epe'])} scenes of "
          f"{manifest['size'][0]}x{manifest['size'][1]}, max_disp "
          f"{sorted(set(res['max_disp']))}): mean EPE {res['mean_epe']:.5g} "
          f"(per scene " + ", ".join(f"{e:.4f}" for e in res["epe"])
          + f"), JAX's {want['mean_epe']} (per scene "
          + ", ".join(map(str, want["epe_per_scene"]))
          + f"): |delta| {delta:.4g}, tol {DS_EPE_TOL}; "
          f"{res['ms_per_batch']:.2f} ms a batch; launches "
          f"{json.dumps(res['launches'])}; kernel vs plain mean |delta "
          f"disp| " + ", ".join(f"{d:.4g}" for d in deltas) + " px",
          flush=True)
    if not delta <= DS_EPE_TOL:
        fail(f"drivingstereo_eval: mean EPE {res['mean_epe']:.5g}, JAX's "
             f"{want['mean_epe']}: |delta| {delta:.4g} > {DS_EPE_TOL}")
    return res


def model_knobs_phase(torch, spamat, counters, gen):
    """Each configuration of KNOBS built by the train CLI's entry
    (`prepare` from the faithful recipe with `--set model.<knob>`, fresh
    weights): one 540x972 request (host masks, `predict`) kernel path
    against plain path, with its launches (the moments and the warp once
    a fine stage, none with one stage); then one train step at B = 8 of
    162x486 held to a plain-path step (`step_checks`, without planted
    faults), timed, with its launches and peak memory."""
    from decnet_tpu_torch.cli import train as tcli
    from decnet_tpu_torch.cli.demo import host_masks, predict
    from decnet_tpu_torch.data.synthetic import synthetic_pair
    from decnet_tpu_torch.train.step import train_step
    H, W, D = SERVE
    left, right, gt, valid = synthetic_pair(H, W, gen, DEV)
    ckpt_dir = os.path.join(ROOT, "build", "decnet_tpu_torch",
                            "smoke_ckpt_knobs")
    out = {}
    for name, knob in KNOBS.items():
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        argv = ["--config", os.path.join(CKPT, "config.json"),
                "--dataset", "synthetic", "--steps", "1", "--ckpt_dir",
                ckpt_dir, "--device", DEV]
        for k, v in knob.items():
            argv += ["--set", f"model.{k}={v}"]
        run = tcli.prepare(argv)
        cfg, model = run.cfg, run.state.model
        n_fine = cfg.model.num_stage - 1
        if (cfg.model.base_channels, cfg.model.max_disp) != KNOB_WIDTH or any(
                getattr(cfg.model, k) != v for k, v in knob.items()):
            fail(f"model_knobs {name}: config {cfg.model}")
        # one request, eval mode
        model.eval()
        masks = host_masks(left, right, cfg.model)
        with torch.no_grad():
            predict(model, left, right, *masks, D)          # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launches(counters)
            t = time.perf_counter()
            pred = predict(model, left, right, *masks, D)
            torch.cuda.synchronize()
            req_ms = (time.perf_counter() - t) * 1e3
            req_peak = torch.cuda.max_memory_allocated() / 2 ** 20
            launches = count_launches(counters)
            model.use_kernels = False
            plain = predict(model, left, right, *masks, D)
            model.use_kernels = True
        want = {k: n_fine if k in ("spamat_moments", "warp") else 0
                for k in counters}
        if launches != want or count_launches(counters) != launches:
            fail(f"model_knobs {name}: request launches {launches} (then "
                 f"{count_launches(counters)} after the plain path), "
                 f"expected {want}")
        if pred.shape != (1, H, W) or not torch.isfinite(pred).all():
            fail(f"model_knobs {name}: prediction {tuple(pred.shape)} not "
                 f"finite")
        delta = float((plain - pred).abs().mean())
        if not delta <= SERVE_MEAN_TOL:
            fail(f"model_knobs {name} kernel vs plain path: mean |delta "
                 f"disp| {delta:.4g} px > {SERVE_MEAN_TOL}")
        # one train step, and the step checks on the same batch
        b = next(run.stream)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches(counters)
        t = time.perf_counter()
        logs = run.step(b)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3
        step_peak = torch.cuda.max_memory_allocated() / 2 ** 20
        step_launches = count_launches(counters)
        if step_launches != {k: n_fine for k in counters}:
            fail(f"model_knobs {name}: step launches {step_launches}, "
                 f"expected {n_fine} of each kernel")
        if not math.isfinite(float(logs["total"])):
            fail(f"model_knobs {name}: non-finite loss")
        checks = step_checks(torch, spamat, model, b, cfg,
                             f"model_knobs {name}", faults={})
        del run, model
        torch.cuda.empty_cache()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        out[name] = {"request_ms": req_ms, "request_peak_mem_mb": req_peak,
                     "request_launches": launches,
                     "plain_mean_abs_delta_px": delta,
                     "epe_px": float((pred - gt).abs()[valid].mean()),
                     "step_ms": step_ms, "step_peak_mem_mb": step_peak,
                     "step_launches": step_launches,
                     "loss": float(logs["total"]), **checks}
        print(f"  {name}: request {req_ms:.3f} ms (peak {req_peak:.1f} "
              f"MiB, launches {json.dumps(launches)}, kernel vs plain mean "
              f"|delta disp| {delta:.5g} px); step B={b['left'].shape[0]} "
              f"{step_ms:.2f} ms (peak {step_peak:.1f} MiB, launches "
              f"{json.dumps(step_launches)}, loss {float(logs['total']):.5g})"
              + ("" if n_fine else "; one stage: no fine stage, so no "
                 "kernel launches and no matching-input check"), flush=True)
    return out


def middlebury_full_skip_phase(torch, counters):
    """The Middlebury-F forward of datasets_eval (1998x2970, max_disp 810)
    with ckpt_faithful built for skip_stage_id 3: kernel path against
    plain path, stage 3 launching nothing (2 moments and 2 warps a
    forward), time and peak memory beside the unskipped forward's on the
    same inputs in this run."""
    from decnet_tpu_torch.cli.demo import host_masks, predict
    from decnet_tpu_torch.weights import load_checkpoint
    h, w = MID_F_SHAPE
    with raw_scenes() as ds:
        b = next(ds.device_batch_stream(17, val=True, batch=1, h=h, w=w,
                                        max_disp=MID_F_NDISP, device=DEV))
    left, right = b["left"] / 255.0, b["right"] / 255.0
    valid = (b["gt"] > 0) & (b["gt"] < MID_F_NDISP)
    out = {}
    for name, kw in (("skip", {"skip_stage_id": SKIP_STAGE}),
                     ("full", {})):
        model = load_checkpoint(CKPT, device=DEV, **kw)
        masks = host_masks(left, right, model.cfg)
        with torch.no_grad():
            predict(model, left, right, *masks, MID_F_NDISP)   # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launches(counters)
            t = time.perf_counter()
            pred = predict(model, left, right, *masks, MID_F_NDISP)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            launches = count_launches(counters)
            model.use_kernels = False
            plain = predict(model, left, right, *masks, MID_F_NDISP)
            model.use_kernels = True
        fine = SKIP_STAGE - 1 if name == "skip" else 3
        want = {k: fine if k in ("spamat_moments", "warp") else 0
                for k in counters}
        if launches != want or count_launches(counters) != launches:
            fail(f"middlebury_full_skip {name}: launches {launches}, "
                 f"expected {want} (stage 3 launches nothing when skipped)")
        if pred.shape != (1, h, w) or not torch.isfinite(pred).all():
            fail(f"middlebury_full_skip {name}: prediction "
                 f"{tuple(pred.shape)} not finite")
        delta = float((plain - pred).abs().mean())
        if not delta <= SERVE_MEAN_TOL:
            fail(f"middlebury_full_skip {name} kernel vs plain path: mean "
                 f"|delta disp| {delta:.4g} px > {SERVE_MEAN_TOL}")
        out[name] = {"ms": ms, "peak_mem_mb": peak, "launches": launches,
                     "plain_mean_abs_delta_px": delta,
                     "epe_px": float((pred - b["gt"]).abs()[valid].mean())}
        print(f"  middlebury_f {h}x{w} max_disp {MID_F_NDISP} {name}: "
              f"{ms:.2f} ms, peak {peak:.1f} MiB, EPE "
              f"{out[name]['epe_px']:.4g} px, launches "
              f"{json.dumps(launches)}, kernel vs plain mean |delta disp| "
              f"{delta:.4g} px", flush=True)
        del model
        torch.cuda.empty_cache()
    return out


def standalone_matching_phase(torch, spamat, gen):
    """`ops/matching.py::sparse_matching` and `sparse_var` (default and
    full_grad) on their kernel path (the moments, dRef and dTar kernels)
    against their plain path at the three fine-stage shapes of a request,
    f32 and bf16: the outputs (STANDALONE_OUT_TOL of the largest plain
    output), the ref and tar gradients and SpaVar's disparity gradient
    (BWD_TOL of the largest plain gradient).
    Then SpaMat's gradients with dRef or dTar zeroed, which the same check
    must reject."""
    from decnet_tpu_torch.ops import matching as tm

    def run(fn, ref, tar, disp, g, use_kernel, **kw):
        r = ref.detach().clone().requires_grad_()
        t = tar.detach().clone().requires_grad_()
        d = disp.detach().clone().requires_grad_()
        args = (r, t, rm, tmk) + ((d,) if fn is tm.sparse_var else ())
        o = fn(*args, D, use_kernel=use_kernel, **kw)
        o.backward(g)
        return o.detach(), r.grad, t.grad, d.grad

    def rel(a, b):
        if a is None or b is None:
            return 0.0 if a is b else float("inf")
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        return err / scale if scale > 0 else (0.0 if err == 0 else
                                              float("inf"))

    rec = []
    for C, H, W, D in STAGES:
        rm, tmk, feat32, tar32, disp = stage_inputs(torch, gen, 1, C, H, W, D)
        g = torch.randn(1, H, W, generator=gen, device=DEV)
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[-1]
            ref, tar = feat32.to(dt), tar32.to(dt)
            for op, fn, kw in (("sparse_matching", tm.sparse_matching, {}),
                               ("sparse_var", tm.sparse_var, {}),
                               ("sparse_var_full_grad", tm.sparse_var,
                                {"full_grad": True})):
                got = run(fn, ref, tar, disp, g, True, **kw)
                want = run(fn, ref, tar, disp, g, False, **kw)
                torch.cuda.synchronize()
                out_err = rel(got[0], want[0])
                errs = {k: rel(a, b) for k, a, b in zip(
                    ("ref", "tar", "disparity"), got[1:], want[1:])}
                case = f"{op} C={C} H={H} W={W} D={D} {dname}"
                print(f"  {case}: output rel err {out_err:.4g}, "
                      + ", ".join(f"{k} grad rel err {v:.4g}"
                                  for k, v in errs.items()), flush=True)
                if not out_err <= STANDALONE_OUT_TOL or not all(
                        v <= BWD_TOL[dname] for v in errs.values()):
                    fail(f"standalone_matching {case}: output rel err "
                         f"{out_err:.4g} (tol {STANDALONE_OUT_TOL}), "
                         f"gradients {errs} (tol {BWD_TOL[dname]})")
                if op == "sparse_var" and (got[1].any() or got[2].any()):
                    fail(f"standalone_matching {case}: feature gradients "
                         f"without full_grad")
                rec.append({"op": op, "shape": [C, H, W, D], "dtype": dname,
                            "output_rel_err": out_err,
                            **{f"{k}_grad_rel_err": v
                               for k, v in errs.items()}})
    # a zeroed backward kernel must fail the gradient check
    C, H, W, D = STAGES[1]
    rm, tmk, feat32, tar32, disp = stage_inputs(torch, gen, 1, C, H, W, D)
    g = torch.randn(1, H, W, generator=gen, device=DEV)
    want = run(tm.sparse_matching, feat32, tar32, disp, g, False)
    faults = {}
    for fault in ("dref_zeroed", "dtar_zeroed"):
        name, _, planted = FAULTS[fault]
        real = getattr(spamat, name)
        setattr(spamat, name, functools.wraps(real)(planted(torch, real)))
        try:
            got = run(tm.sparse_matching, feat32, tar32, disp, g, True)
        finally:
            setattr(spamat, name, real)
        errs = {k: rel(a, b) for k, a, b in zip(("ref", "tar"), got[1:3],
                                                want[1:3])}
        rejected = not all(v <= BWD_TOL["float32"] for v in errs.values())
        faults[fault] = {**errs, "rejected": rejected}
        print(f"  planted fault {fault}: ref grad rel err "
              f"{errs['ref']:.4g}, tar {errs['tar']:.4g} -> "
              f"{'rejected' if rejected else 'passed'}", flush=True)
        if not rejected:
            fail(f"standalone_matching: the gradient check passed with "
                 f"{fault}")
    return {"cases": rec, "planted_faults": faults}


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="", help="also write the records here")
    args = p.parse_args()
    t_all = time.perf_counter()

    # -- 1. environment
    t0 = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a card")
    if not (os.path.isdir(os.path.join(ROOT, "decnet_tpu_torch"))
            and all(os.path.isfile(os.path.join(c, "params.npz"))
                    for c in (CKPT, CKPT_DETAIL))):
        fail(f"{ROOT} does not hold the port and its checkpoints")
    sys.path.insert(0, ROOT)
    from decnet_tpu_torch.cli.demo import host_masks, predict
    from decnet_tpu_torch.data.synthetic import synthetic_pair
    from decnet_tpu_torch.ops.kernels import build
    from decnet_tpu_torch.ops.kernels import spamat
    from decnet_tpu_torch.ops.kernels import warp as kwarp
    from decnet_tpu_torch.weights import load_checkpoint

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    print(card, flush=True)
    phase("environment", t0, torch=torch.__version__,
          cuda=torch.version.cuda, device=json.dumps(kind), count=count)

    # -- 2. build
    t0 = time.perf_counter()
    results = build.build(["spamat_moments", "warp", "spamat_backward",
                           "spamat_dtar", build.HOST_LIB, build.PNG_LIB,
                           build.JPEG_LIB])
    for r in results:
        for line in r.ptxas.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                print(f"  {r.name}: {line.strip()}", flush=True)
    phase("build", t0, **{f"{r.name}_s": f"{r.seconds:.2f}" for r in results})

    # -- 3. kernel parity and timing
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(args.seed)
    flush_buf = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=DEV)
    # what the timing reads for a kernel that does next to nothing, after
    # the flush as every kernel here is timed, and without it
    one = torch.zeros(1, device=DEV)
    floor_ms = time_cuda(torch, lambda: one.add_(1), 20, flush_buf)
    floor_no_flush_ms = time_cuda(torch, lambda: one.add_(1), 20, None)
    with torch.no_grad():
        parity = kernel_parity(torch, spamat, kwarp, gen, flush_buf)
        extra = kernel_parity_extra(torch, spamat, kwarp, gen)
        parity_train = kernel_parity(torch, spamat, kwarp, gen, flush_buf,
                                     TRAIN_STAGES, TRAIN_B)
        windowed = windowed_parity(torch, spamat, gen, flush_buf)
        windowed_train = windowed_parity(torch, spamat, gen, flush_buf,
                                         TRAIN_WINDOWED_STAGES, TRAIN_B)
        # the bench's batch (cli/bench.py, B = 4 of 540x972)
        print("  -- bench batch", flush=True)
        parity_bench = kernel_parity(torch, spamat, kwarp, gen, flush_buf,
                                     STAGES, BENCH_B)
        # the benchmark suites' shapes (B = 1): KITTI, Middlebury-H (the
        # forward splits rows at stage 3), Middlebury-F
        suite_parity = {}
        for suite, stages in SUITE_STAGES.items():
            print(f"  -- {suite}", flush=True)
            suite_parity[suite] = kernel_parity(torch, spamat, kwarp, gen,
                                                flush_buf, stages)
    phase("kernel_parity", t0, shapes=2 * len(STAGES) + len(TRAIN_STAGES),
          suite_shapes=sum(len(v) for v in SUITE_STAGES.values()),
          windowed_shapes=len(WINDOWED_STAGES) + len(TRAIN_WINDOWED_STAGES),
          dtypes=2, timing_floor_ms=f"{floor_ms:.4g}",
          timing_floor_no_flush_ms=f"{floor_no_flush_ms:.4g}",
          **{k: f"{v:.3g}" for k, v in extra.items()})

    # -- 3b. backward kernels against their plain version
    t0 = time.perf_counter()
    with torch.no_grad():
        bwd = backward_parity(torch, spamat, gen, flush_buf)
        # KITTI's training crop, B = 8 of 270x513
        print("  -- kitti training crop", flush=True)
        bwd_kitti = backward_parity(
            torch, spamat, gen, flush_buf,
            [(TRAIN_B, shape, dt, 0, False, False)
             for shape in KITTI_TRAIN_STAGES
             for dt in (torch.float32, torch.bfloat16)], "_kitti")
    phase("backward_parity", t0, shapes=len(TRAIN_STAGES), dtypes=2,
          windowed=1 + len(TRAIN_WINDOWED_STAGES), adversarial=1,
          split_rows=len(SPLIT_ROW_STAGES),
          kitti_shapes=len(KITTI_TRAIN_STAGES),
          **{f"{k}_max_rel_err": f"{max(r['rel_err'] for r in v):.3g}"
             for k, v in {**bwd, **bwd_kitti}.items()})

    # -- 4. load
    t0 = time.perf_counter()
    model = load_checkpoint(CKPT, device=DEV)
    nparams = sum(t.numel() for t in model.state_dict().values())
    phase("load", t0, dtype=model.cfg.dtype, tensors=len(model.state_dict()),
          values=nparams)

    # -- 5. serve
    t0 = time.perf_counter()
    H, W, D = SERVE
    requests = [synthetic_pair(H, W, gen, DEV)
                for _ in range(REQUESTS + 1)]
    warm, requests = requests[0], requests[1:]

    def serve(left, right):
        """One request as the demo serves it: host masks, then predict."""
        masks = host_masks(left, right, model.cfg)
        t_masks = time.perf_counter()
        return predict(model, left, right, *masks, D), masks, t_masks

    serve(warm[0], warm[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spamat.moments.launches = 0
    kwarp.warp.launches = 0
    preds, masks, lat, mask_ms = [], [], [], []
    for left, right, _, _ in requests:
        t = time.perf_counter()
        pred, m, t_masks = serve(left, right)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        mask_ms.append((t_masks - t) * 1e3)
        preds.append(pred)
        masks.append(m)
    launches = {"spamat_moments": spamat.moments.launches,
                "warp": kwarp.warp.launches}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for i, ms in enumerate(lat):
        print(f"  request {i}: {ms:.3f} ms", flush=True)
    print("  host masks (inside each request): "
          + ", ".join(f"{x:.3f}" for x in mask_ms) + " ms", flush=True)
    want = 3 * REQUESTS
    for k, n in launches.items():
        if n != want:
            fail(f"{k} launched {n} times in {REQUESTS} requests, "
                 f"expected {want}")
    epes = []
    for pred, (_, _, gt, valid) in zip(preds, requests):
        if pred.shape != (1, H, W) or not torch.isfinite(pred).all():
            fail(f"prediction of shape {tuple(pred.shape)} not finite")
        lo, hi = float(pred.min()), float(pred.max())
        if lo < -16 or hi > D:
            fail(f"prediction range [{lo:.3f}, {hi:.3f}] outside [-16, {D}]")
        epes.append(float((pred - gt).abs()[valid].mean()))
    model.use_kernels = False
    deltas = []
    for pred, m, (left, right, _, _) in zip(preds, masks, requests):
        plain = predict(model, left, right, *m, D)
        deltas.append((plain - pred).abs().flatten())
    model.use_kernels = True
    delta = torch.cat(deltas)
    mean_delta = float(delta.mean())
    p999 = float(torch.quantile(delta.float(), 0.999))
    if spamat.moments.launches != want or kwarp.warp.launches != want:
        fail("the plain path launched a kernel")
    if not mean_delta <= SERVE_MEAN_TOL:
        fail(f"kernel vs plain path: mean |delta disp| {mean_delta:.4g} px "
             f"> {SERVE_MEAN_TOL}")
    del model
    torch.cuda.empty_cache()
    phase("serve", t0, requests=REQUESTS, size=f"{H}x{W}", max_disp=D,
          latency_ms=",".join(f"{x:.3f}" for x in lat),
          host_masks_ms=",".join(f"{x:.3f}" for x in mask_ms),
          peak_mem_mb=f"{peak_mb:.1f}", launches=json.dumps(launches),
          plain_mean_abs_delta_px=f"{mean_delta:.5g}",
          plain_p999_abs_delta_px=f"{p999:.5g}",
          epe_px=",".join(f"{e:.4f}" for e in epes))

    # -- 6. train
    t0 = time.perf_counter()
    counters = {"spamat_moments": spamat.moments, "warp": kwarp.warp,
                "spamat_dref": spamat.spamat_dref,
                "spamat_dtar": spamat.spamat_dtar}
    train = train_phase(torch, counters)
    b, h, w, d, dt = TRAIN_SHAPE
    phase("train", t0, steps=TRAIN_STEPS, batch=b, size=f"{h}x{w}",
          max_disp=d, dtype=dt,
          step_ms=",".join(f"{x:.2f}" for x in train["step_ms"]),
          warmup_ms=f"{train['warmup_ms']:.1f}",
          peak_mem_mb=f"{train['peak_mem_mb']:.1f}",
          launches=json.dumps(train["launches"]),
          loss=",".join(f"{x:.4f}" for x in train["losses"]),
          plain_loss_rel=f"{train['plain_loss_rel']:.3g}",
          plain_grad_cos=f"{train['plain_grad_cos']:.6f}",
          plain_matching_grad_cos=f"{train['plain_matching_grad_cos']:.6f}",
          planted_fault_grad_cos=",".join(
              f"{k}:{v['grad_cos']:.4g}/{v['matching_grad_cos']:.4g}"
              for k, v in train["planted_faults"].items()))

    # -- 6b. ckpt_detail_r5's recipe trained: s2d, window, learned detail
    t0 = time.perf_counter()
    train_s2d = train_s2d_phase(torch, counters)
    torch.cuda.empty_cache()
    ts = train_s2d
    phase("train_s2d", t0, checkpoint="runs/ckpt_detail_r5",
          steps=TRAIN_S2D_STEPS, batch=b, size=f"{h}x{w}", max_disp=d,
          dtype=dt, windows=",".join(map(str, WINDOWS)),
          step_ms=",".join(f"{x:.2f}" for x in ts["step_ms"]),
          warmup_ms=f"{ts['warmup_ms']:.1f}",
          peak_mem_mb=f"{ts['peak_mem_mb']:.1f}",
          launches=json.dumps(ts["launches"]),
          loss=",".join(f"{x:.4f}" for x in ts["losses"]),
          plain_loss_rel=f"{ts['plain_loss_rel']:.3g}",
          plain_grad_cos=f"{ts['plain_grad_cos']:.7f}",
          plain_matching_grad_cos=f"{ts['plain_matching_grad_cos']:.7f}",
          planted_faults=",".join(
              f"{k}:{v['grad_cos']:.5g}/{v['matching_grad_cos']:.5g}"
              f"{':rejected' if v['rejected'] else ':passed'}"
              for k, v in ts["planted_faults"].items()),
          resume_bit_exact=ts["resume_bit_exact"],
          params_npz_arrays=ts["params_npz_arrays"])

    # -- 7. the s2d model with learned masks and windowed matching, served
    t0 = time.perf_counter()
    s2d = serve_s2d_phase(torch, spamat, kwarp, gen)
    torch.cuda.empty_cache()
    phase("serve_s2d", t0, checkpoint="runs/ckpt_detail_r5",
          requests=REQUESTS, size=f"{H}x{W}", max_disp=D,
          latency_ms=",".join(f"{x:.3f}" for x in s2d["latency_ms"]),
          peak_mem_mb=f"{s2d['peak_mem_mb']:.1f}",
          launches=json.dumps(s2d["launches"]),
          plain_mean_abs_delta_px=f"{s2d['plain_mean_abs_delta_px']:.5g}",
          plain_p999_abs_delta_px=f"{s2d['plain_p999_abs_delta_px']:.5g}",
          epe_px=",".join(f"{e:.4f}" for e in s2d["epe_px"]))

    # -- 7b. cli/bench.py at its full size, its three variants
    t0 = time.perf_counter()
    bench_run = bench_phase(torch, counters)
    br = bench_run["record"]
    phase("bench", t0, batch=BENCH_B, size=f"{H}x{W}", max_disp=D,
          pairs_per_sec=br["value"],
          faithful_pairs_per_sec=br["faithful_pairs_per_sec"],
          faithful_nhwc_pairs_per_sec=br["faithful_nhwc_pairs_per_sec"],
          rounds=json.dumps(br["rounds_pairs_per_sec"]),
          peak_mem_mb=json.dumps(br["peak_mem_mb"]),
          launches=json.dumps(bench_run["launches"]),
          faithful_vs_nhwc_mean_abs_delta_px="{:.5g}".format(
              bench_run["faithful_vs_nhwc_mean_abs_delta_px"]),
          ckpt_faithful_f32_packed_mean_abs_delta_px="{:.5g}".format(
              bench_run["ckpt_faithful_packed_mean_abs_delta_px"]),
          ckpt_faithful_bf16_from_f32_px="{faithful:.5g}/{packed:.5g}"
          "(ratio {ratio:.4g}, between {between:.5g})".format(
              **bench_run["ckpt_faithful_bf16"]))

    # -- 7c. the flagship configuration (s2d_stages 2), one request
    t0 = time.perf_counter()
    flagship = serve_flagship_phase(torch, counters, gen)
    phase("serve_flagship", t0, size=f"{H}x{W}", max_disp=D,
          latency_ms=f"{flagship['latency_ms']:.3f}",
          peak_mem_mb=f"{flagship['peak_mem_mb']:.1f}",
          launches=json.dumps(flagship["launches"]),
          mask_density=",".join(f"{d:.3f}"
                                for d in flagship["mask_density"]),
          plain_mean_abs_delta_px=f"{flagship['plain_mean_abs_delta_px']:.5g}")

    # -- 8. accuracy against the JAX anchors
    t0 = time.perf_counter()
    evals = eval_phase(torch, spamat, kwarp)
    torch.cuda.empty_cache()
    phase("eval", t0, **{f"{k}_stage3_epe": f"{r['stage3_epe']:.5g}"
                         for k, r in evals.items()},
          **{f"{k}_band": f"{r['anchor_stage3_epe']}+-{r['band']:.4g}"
             for k, r in evals.items()},
          faithful_sparse_contribution_epe=f"{evals['ckpt_faithful']['sparse_contribution_epe']:.4g}")

    # -- 10. the benchmark suites' files: made, evaluated, trained on
    tmp = tempfile.mkdtemp(prefix="decnet_smoke_")
    try:
        t0 = time.perf_counter()
        roots = write_suites(torch, tmp)
        phase("suite_files", t0, root=tmp,
              sceneflow=f"{SF_SCENES}x{EVAL['h']}x{EVAL['w']}",
              sceneflow_960=f"{SF_CUT_SCENES}x{SF_SHAPE[0]}x{SF_SHAPE[1]}",
              kitti=f"{KITTI_SCENES}x{KITTI_SHAPE[0]}x{KITTI_SHAPE[1]}",
              middlebury_h=f"{len(MID_H_NDISP)}x{MID_H_SHAPE[0]}x"
                           f"{MID_H_SHAPE[1]}")
        t0 = time.perf_counter()
        dse = datasets_eval_phase(torch, counters, roots,
                                  os.path.join(tmp, "eval_out"),
                                  evals["ckpt_faithful"]["stage3_epe"])
        phase("datasets_eval", t0,
              sceneflow_epe=f"{dse['sceneflow']['mean_epe']:.5g}",
              sceneflow_band=f"{SF_ANCHOR[2]}+-{dse['sceneflow']['band']:.4g}",
              sceneflow_ms_per_batch=f"{dse['sceneflow']['ms_per_batch']:.2f}",
              sceneflow_960_epe=f"{dse['sceneflow_960']['mean_epe']:.5g}",
              kitti_max_disp=",".join(map(str, dse["kitti"]["max_disp"])),
              middlebury_max_disp=",".join(
                  map(str, dse["middlebury"]["max_disp"])),
              plain_mean_abs_delta_px=",".join(
                  f"{d:.4g}" for k in ("kitti", "middlebury")
                  for d in dse[k]["plain_mean_abs_delta_px"]),
              submission_max_err_px="{:.4g}".format(
                  dse["kitti"]["submission_max_err_px"]),
              middlebury_f_ms=f"{dse['middlebury_f']['ms']:.2f}",
              middlebury_f_peak_mem_mb="{:.1f}".format(
                  dse["middlebury_f"]["peak_mem_mb"]))
        t0 = time.perf_counter()
        exs = exec_s2d_phase(torch, spamat, counters, roots,
                             os.path.join(tmp, "eval_out"),
                             dse["sceneflow"]["mean_epe"])
        phase("exec_s2d_packed_exec", t0,
              exec_s2d_epe=f"{exs['eval']['mean_epe']:.5g}",
              plain_epe=f"{exs['eval_plain_epe']:.5g}",
              packed_loss_rel=f"{exs['loss_rel']:.3g}",
              packed_grad_cos=f"{exs['grad_cos']:.7f}",
              packed_worst_leaf="{}:{:.4g}".format(*exs["worst_leaf"]),
              faithful_twice_worst_leaf="{}:{:.4g}".format(
                  *exs["faithful_twice_worst_leaf"]),
              planted_faults=",".join(
                  "{}:cos {:.7f} worst {}:{:.4g} {}".format(
                      k, v["grad_cos"], *v["worst_leaf"],
                      "rejected" if v["rejected"] else "passed")
                  for k, v in exs["planted_faults"].items()),
              frozen_step_ms=json.dumps({k: [round(x, 2) for x in v]
                                         for k, v in exs["step_ms"].items()}),
              launches=json.dumps(exs["launches"]))
        t0 = time.perf_counter()
        dst = datasets_train_phase(torch, spamat, counters, roots)
        phase("datasets_train", t0, steps=TRAIN_DISK_STEPS, batch=b,
              size=f"{h}x{w}",
              step_ms=",".join(f"{x:.2f}" for x in dst["step_ms"]),
              loader_wait_ms=",".join(f"{x:.2f}"
                                      for x in dst["loader_wait_ms"]),
              loader_wait_share=f"{dst['loader_wait_share']:.4f}",
              launches=json.dumps(dst["launches"]),
              plain_loss_rel=f"{dst['plain_loss_rel']:.3g}",
              plain_grad_cos=f"{dst['plain_grad_cos']:.7f}",
              plain_matching_grad_cos=f"{dst['plain_matching_grad_cos']:.7f}",
              planted_faults=",".join(
                  f"{k}:{v['grad_cos']:.5g}/{v['matching_grad_cos']:.5g}"
                  f"{':rejected' if v['rejected'] else ':passed'}"
                  for k, v in dst["planted_faults"].items()),
              **{f"{k}_2_steps_s": f"{v['seconds']:.2f}"
                 for k, v in dst["others"].items()})
        t0 = time.perf_counter()
        ref_import = reference_import_phase(torch, gen, tmp)
        phase("reference_import", t0, arrays=ref_import["arrays"],
              bit_equal=ref_import["bit_equal"])
        t0 = time.perf_counter()
        demo_cli = demo_cli_phase(torch, counters, roots["sceneflow_960"],
                                  tmp)
        phase("demo_cli", t0, **{f"{k}_max_err_px": f"{v['max_err_px']:.4g}"
                                 for k, v in demo_cli.items()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 11. DrivingStereo's JPEG files, decoded and evaluated
    t0 = time.perf_counter()
    jpeg = jpeg_files_phase()
    phase("jpeg_files", t0, images=jpeg["images"], sha256_equal=True,
          ms_per_image=f"{jpeg['mean_ms']:.3f}",
          ms_range=f"{min(jpeg['ms']):.3f}-{max(jpeg['ms']):.3f}")
    t0 = time.perf_counter()
    ds_out = tempfile.mkdtemp(prefix="decnet_smoke_ds_")
    try:
        dse_ds = drivingstereo_eval_phase(torch, counters, ds_out,
                                          jpeg["manifest"])
    finally:
        shutil.rmtree(ds_out, ignore_errors=True)
    phase("drivingstereo_eval", t0, mean_epe=f"{dse_ds['mean_epe']:.5g}",
          jax_mean_epe=dse_ds["jax_mean_epe"],
          epe_delta=f"{dse_ds['epe_delta']:.4g}",
          ms_per_batch=f"{dse_ds['ms_per_batch']:.2f}",
          launches=json.dumps(dse_ds["launches"]),
          plain_mean_abs_delta_px=",".join(
              f"{d:.4g}" for d in dse_ds["plain_mean_abs_delta_px"]))

    # -- 12. the model configurations beyond the faithful one
    t0 = time.perf_counter()
    knobs = model_knobs_phase(torch, spamat, counters, gen)
    phase("model_knobs", t0, configs=",".join(knobs),
          request_ms=",".join(f"{v['request_ms']:.2f}"
                              for v in knobs.values()),
          step_ms=",".join(f"{v['step_ms']:.2f}" for v in knobs.values()),
          peak_mem_mb=",".join(
              f"{v['request_peak_mem_mb']:.0f}/{v['step_peak_mem_mb']:.0f}"
              for v in knobs.values()),
          plain_mean_abs_delta_px=",".join(
              f"{v['plain_mean_abs_delta_px']:.4g}" for v in knobs.values()),
          plain_loss_rel=",".join(f"{v['plain_loss_rel']:.3g}"
                                  for v in knobs.values()),
          plain_grad_cos=",".join(f"{v['plain_grad_cos']:.6f}"
                                  for v in knobs.values()),
          plain_matching_grad_cos=",".join(
              f"{v['plain_matching_grad_cos']:.6f}" for v in knobs.values()),
          launches=json.dumps({k: [v["request_launches"]["spamat_moments"],
                                   v["step_launches"]["spamat_dref"]]
                               for k, v in knobs.items()}))

    # -- 13. Middlebury-F with the bicubic skip of stage 3
    t0 = time.perf_counter()
    skip = middlebury_full_skip_phase(torch, counters)
    phase("middlebury_full_skip", t0, size=f"{MID_F_SHAPE[0]}x"
          f"{MID_F_SHAPE[1]}", max_disp=MID_F_NDISP,
          skip_stage_id=SKIP_STAGE, ms=f"{skip['skip']['ms']:.2f}",
          unskipped_ms=f"{skip['full']['ms']:.2f}",
          peak_mem_mb=f"{skip['skip']['peak_mem_mb']:.1f}",
          unskipped_peak_mem_mb=f"{skip['full']['peak_mem_mb']:.1f}",
          launches=json.dumps(skip["skip"]["launches"]),
          plain_mean_abs_delta_px="{:.4g}".format(
              skip["skip"]["plain_mean_abs_delta_px"]),
          epe_px=f"{skip['skip']['epe_px']:.4g}",
          unskipped_epe_px=f"{skip['full']['epe_px']:.4g}")

    # -- 14. standalone SpaMat and SpaVar against their plain versions
    t0 = time.perf_counter()
    standalone = standalone_matching_phase(torch, spamat, gen)
    phase("standalone_matching", t0, cases=len(standalone["cases"]),
          max_output_rel_err="{:.3g}".format(max(
              c["output_rel_err"] for c in standalone["cases"])),
          max_grad_rel_err="{:.3g}".format(max(
              max(c[f"{k}_grad_rel_err"] for k in ("ref", "tar",
                                                   "disparity"))
              for c in standalone["cases"])),
          planted_faults=",".join(
              f"{k}:{'rejected' if v['rejected'] else 'passed'}"
              for k, v in standalone["planted_faults"].items()))

    # -- 9. the kernels line: per kernel, the launches of each path's run;
    # times summed over the three fine-stage shapes of its main path
    # (serving, one 540x972 request, for the forward kernels; a training
    # batch for the backward ones), bf16, with the forward kernels' times
    # at the training shapes beside them.  The windowed modes are entries
    # of their own, with the launches of the paths that run them.
    sources = {"spamat_moments": ("decnet_tpu_torch/csrc/spamat_moments.cu",
                                  "decnet_tpu/ops/pallas/spamat.py:80"),
               "warp": ("decnet_tpu_torch/csrc/warp.cu",
                        "decnet_tpu/ops/pallas/warp.py:49"),
               "spamat_dref": ("decnet_tpu_torch/csrc/spamat_backward.cu",
                               "decnet_tpu/ops/pallas/spamat.py:239"),
               "spamat_dtar": ("decnet_tpu_torch/csrc/spamat_dtar.cu",
                               "decnet_tpu/ops/pallas/spamat.py:287")}

    def summed(recs):
        timed = [r for r in recs if "ms" in r]
        lib = [r["library_ms"] for r in timed]
        return {"ms": sum(r["ms"] for r in timed),
                "plain_ms": sum(r["plain_ms"] for r in timed),
                "bound_ms": sum(r["bound_ms"] for r in timed),
                "bound_by": max(timed, key=lambda r: r["bound_ms"])[
                    "bound_by"],
                "library_ms": None if None in lib else sum(lib)}

    kernels = []
    full_band = [(n, r) for n, r in bwd.items() if not n.endswith("windowed")]
    for name, recs in list(parity.items()) + full_band:
        by_path = {"train": train["launches"][name]}
        if name in launches:
            by_path = {"serve": launches[name], **by_path}
            by_path["serve_flagship"] = flagship["launches"][name]
            by_path["exec_s2d_eval"] = exs["eval_launches"][name]
        if name == "warp":
            by_path["train_s2d"] = train_s2d["launches"][name]
        by_path["packed_exec_train"] = exs["launches"]["packed"][name]
        if name in launches:
            by_path["drivingstereo_eval"] = dse_ds["launches"][name]
            by_path["middlebury_full_skip"] = skip["skip"]["launches"][name]
        by_path["model_knobs"] = sum(
            v["request_launches"][name] + v["step_launches"][name]
            for v in knobs.values())
        k = {"name": name, "route": "cuda", "source": sources[name][0],
             "replaces": sources[name][1],
             "launches": sum(by_path.values()), "launches_by_path": by_path,
             "max_abs_err": max(r["max_abs_err"] for r in recs),
             **summed(recs)}
        if name in parity_train:
            k["train_shapes"] = summed(parity_train[name])
            k["max_abs_err"] = max(k["max_abs_err"], max(
                r["max_abs_err"] for r in parity_train[name]))
        kernels.append(k)
    # the moments and the warp at the bench's batch (B = 4), with the
    # launches of the bench's run (its three variants)
    for name, recs in parity_bench.items():
        kernels.append({
            "name": f"{name}_bench_b4", "route": "cuda",
            "source": sources[name][0], "replaces": sources[name][1],
            "launches": bench_run["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            **summed(recs)})
    # the windowed mode of the moments kernel, at the s2d detail path's
    # shapes: its launches on that path (one request each), in the evals
    # and in the s2d training steps (times at those shapes beside)
    by_path = {"serve_s2d": s2d["launches"]["spamat_moments"],
               "eval_ckpt_detail_r5":
                   evals["ckpt_detail_r5"]["launches"]["spamat_moments"],
               "train_s2d": train_s2d["launches"]["spamat_moments"]}
    kernels.append({"name": "spamat_moments_windowed", "route": "cuda",
                    "source": sources["spamat_moments"][0],
                    "replaces": sources["spamat_moments"][1],
                    "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "max_abs_err": max(r["max_abs_err"]
                                       for r in windowed + windowed_train),
                    **summed(windowed),
                    "train_shapes": summed(windowed_train)})
    # the windowed backward kernels, at the s2d training step's shapes
    for name in ("spamat_dref", "spamat_dtar"):
        recs = bwd[f"{name}_windowed"]
        by_path = {"train_s2d": train_s2d["launches"][name]}
        kernels.append({"name": f"{name}_windowed", "route": "cuda",
                        "source": sources[name][0],
                        "replaces": sources[name][1],
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "max_abs_err": max(r["max_abs_err"] for r in recs),
                        **summed(recs)})
    # the suites' shapes: the moments and the warp at the shapes of one
    # forward of each (launches of its eval runs, of its one forward for
    # Middlebury-F), dRef and dTar at KITTI's training crop (launches of
    # its 2 steps)
    suite_launches = {"kitti": dse["kitti"]["launches"],
                      "middlebury_h": dse["middlebury"]["launches"],
                      "middlebury_f": dse["middlebury_f"]["launches"]}
    for suite, par in suite_parity.items():
        for name, recs in par.items():
            kernels.append({
                "name": f"{name}_{suite}", "route": "cuda",
                "source": sources[name][0], "replaces": sources[name][1],
                "launches": suite_launches[suite][name],
                "max_abs_err": max(r["max_abs_err"] for r in recs),
                **summed(recs)})
    for name, recs in bwd_kitti.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": sources[name[:-len("_kitti")]][0],
            "replaces": sources[name[:-len("_kitti")]][1],
            "launches": dst["others"]["kitti15"]["launches"][
                name[:-len("_kitti")]],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            **summed(recs)})
    torch.cuda.synchronize()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kind": kind,
                       "timing_floor_ms": floor_ms,
                       "timing_floor_no_flush_ms": floor_no_flush_ms,
                       "parity": parity,
                       "parity_extra": extra, "parity_train": parity_train,
                       "backward": bwd, "train": train,
                       "windowed": windowed,
                       "windowed_train": windowed_train,
                       "train_s2d": train_s2d, "serve_s2d": s2d,
                       "eval": evals, "suite_parity": suite_parity,
                       "backward_kitti": bwd_kitti, "datasets_eval": dse,
                       "datasets_train": dst,
                       "reference_import": ref_import,
                       "demo_cli": demo_cli,
                       "parity_bench": parity_bench, "bench": bench_run,
                       "serve_flagship": flagship, "exec_s2d": exs,
                       "jpeg_files": {k: v for k, v in jpeg.items()
                                      if k != "manifest"},
                       "drivingstereo_eval": dse_ds, "model_knobs": knobs,
                       "middlebury_full_skip": skip,
                       "standalone_matching": standalone,
                       "latency_ms": lat, "host_masks_ms": mask_ms,
                       "peak_mem_mb": peak_mb,
                       "epe_px": epes, "plain_mean_abs_delta_px": mean_delta,
                       "plain_p999_abs_delta_px": p999, "kernels": kernels,
                       "wall_s": time.perf_counter() - t_all}, f, indent=1)
    print(f"[total] {time.perf_counter() - t_all:.2f}s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
