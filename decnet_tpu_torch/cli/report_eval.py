"""Accuracy report of a checkpoint on the synthetic validation stream — the
port of scripts/report_eval.py.

Per batch of the on-device val stream (`data/device_synth.py`, seed
--seed, --variant): the forward, and again with the sparse branch ablated
(fused = dense).  Reported, each the mean over the batches: EPE and D1 of
every stage's prediction (stage i against the ground truth subsampled to
its resolution), of the ablated final prediction, of stage 0 upsampled
bicubically to full size (the decomposition's baseline), of the final
stage's dense and fused maps; their differences `decomposition_win_epe`
(baseline - final) and `sparse_contribution_epe` (ablated - final); the
final EPE of each batch with its standard error; and the script's
breakdowns at the finest stage (`breakdowns`): the dense, sparse, fusion
and raw sparse errors at the mask pixels (`mask_*`, split by candidate
availability, `_cand` / `_nocand`), the candidate availability
(`cand_avail_exact`, and `cand_avail`, the +-1 px hit test against the
right view's masks), the oracle fusion (`mask_oracle`), the soft mask
where each branch wins (`soft_mask_where_*`, `sparse_win_frac`), the
mask density, and the same at the pixels a 1/27 scale loses (`ld_*`:
|gt - bicubic up(mean-pool-27(gt))| > --ld_thresh).  A breakdown whose
pixel set is empty in a batch leaves that batch out, and is null when it
is empty in every batch, as in the script (the `_d1` of a breakdown is
0.0, as the script records it).

The model config comes from the checkpoint's config.json (without one,
the defaults with --s2d and --use_detail); --thold (default 0.9)
overrides the sidecar's, and --thold_mode and --detail_density when
given, as the script's runtime knobs do.  The card computes in bf16, the
CPU in f32, as the JAX script does on TPU and CPU.

Usage:
  python -m decnet_tpu_torch.cli.report_eval --ckpt runs/ckpt_faithful \\
      --h 540 --w 972 --max_disp 216 --batch 4 --batches 24 --seed 37 \\
      --variant legacy [--json out.json] [--device cuda] [--draws s.npz] \\
      [--exec_s2d 1] [--thold 0.9] [--thold_mode fixed|quantile] \\
      [--detail_density 0.25] [--ld_thresh 9] [--s2d] [--use_detail]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from decnet_tpu_torch.config import VARIANTS, ModelConfig, load_config
from decnet_tpu_torch.data.device_synth import (device_batch_stream,
                                                saved_draw_stream)
from decnet_tpu_torch.device import resolve_device
from decnet_tpu_torch.models.decnet import DecNet
from decnet_tpu_torch.models.repack import s2d_exec_model
from decnet_tpu_torch.ops.resize import interpolate
from decnet_tpu_torch.train.metrics import epe_and_d1
from decnet_tpu_torch.weights import load_flax_variables

LD_DOWN = 27          # the coarsest stage's scale, whose pooling loses detail


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ckpt", required=True,
                   help="checkpoint directory (params.npz, and config.json "
                   "unless --s2d / --use_detail describe the model)")
    p.add_argument("--h", type=int, default=162)
    p.add_argument("--w", type=int, default=243)
    p.add_argument("--max_disp", type=int, default=108)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--batches", type=int, default=16)
    p.add_argument("--s2d", action="store_true",
                   help="the s2d form, for a checkpoint without config.json")
    p.add_argument("--use_detail", action="store_true",
                   help="learned detail heads, for a checkpoint without "
                   "config.json")
    p.add_argument("--thold", type=float, default=0.9,
                   help="the heads' binarisation threshold (overrides the "
                   "checkpoint's, as the script does)")
    p.add_argument("--thold_mode", default=None, choices=("fixed", "quantile"),
                   help="fixed thold, or the per-pair quantile keeping "
                   "--detail_density")
    p.add_argument("--detail_density", type=float, default=None)
    p.add_argument("--seed", type=int, default=37)
    p.add_argument("--variant", default="default", choices=VARIANTS,
                   help="stream recipe: default (z-buffer right view), "
                   "stressor (thin bars over a periodic texture), legacy "
                   "(the round-4 fixed-point renderer)")
    p.add_argument("--ld_thresh", type=float, default=9.0,
                   help="lost-detail pixels: |gt - up27(meanpool27(gt))| > "
                   "this (px)")
    p.add_argument("--draws", default=None,
                   help="evaluate on the saved scenes of this npz "
                   "(`data.device_synth.saved_draw_stream`), e.g. the JAX "
                   "report stream's, instead of the port's stream")
    p.add_argument("--exec_s2d", type=int, default=0,
                   help="run a faithful checkpoint through the exact "
                   "space-to-depth repack (models/repack.py)")
    p.add_argument("--json", default=None, help="also write the report here")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def load_model(ckpt: str, device, *, s2d: bool = False,
               use_detail: bool = False, **overrides) -> DecNet:
    """The checkpoint's model in eval mode on `device`: its config.json
    with `overrides` (max_disp, dtype and the runtime knobs thold,
    thold_mode, detail_density), or without one the default model with
    `s2d` and `use_detail`, as the script builds it."""
    if os.path.exists(os.path.join(ckpt, "config.json")):
        cfg = load_config(ckpt, **overrides)
    else:
        cfg = ModelConfig(s2d_fine=s2d, use_detail=use_detail, **overrides)
    model = DecNet(cfg)
    load_flax_variables(model, os.path.join(ckpt, "params.npz"))
    return model.to(device).eval()


def lost_detail_mask(gt: torch.Tensor, ld_thresh: float,
                     down: int = LD_DOWN) -> torch.Tensor:
    """Pixels whose disparity the coarse scale cannot represent:
    |gt - bicubic up(mean-pool-down(gt))| > ld_thresh (the rows and
    columns beyond a multiple of `down` are left out of the pool)."""
    B, H, W = gt.shape
    g = gt.float()
    coarse = g[:, :H - H % down, :W - W % down].reshape(
        B, H // down, down, W // down, down).mean(dim=(2, 4))
    up = interpolate(coarse[:, None], H, W, "bicubic")[:, 0]
    return (g - up).abs() > ld_thresh


def _masked_mean(x: torch.Tensor, v: torch.Tensor) -> float:
    """Mean of x over v; NaN when v is empty (null in the report: 0.0
    would read as perfect)."""
    v = v.float()
    n = float(v.sum())
    return float((x.float() * v).sum()) / n if n > 0 else math.nan


def cand_avail(lmask: torch.Tensor, gt: torch.Tensor,
               right_mask: torch.Tensor) -> Optional[float]:
    """The share of left mask pixels whose true match (+-1 px) is a right
    detail pixel, over those whose match lies in the image; None when
    there is none.  On the host in numpy, as the script computes it."""
    lm = lmask.cpu().numpy() > 0
    g = gt.float().cpu().numpy()
    rm = right_mask.float().cpu().numpy() > 0
    W = lm.shape[2]
    xs = np.arange(W)[None, None, :]
    src = np.clip(np.round(xs - g).astype(int), 0, W - 1)
    hit = np.zeros_like(lm)
    for dd in (-1, 0, 1):
        hit |= np.take_along_axis(rm, np.clip(src + dd, 0, W - 1), axis=2)
    valid = lm & np.broadcast_to((xs - g) >= 0, lm.shape)
    return float(hit[valid].mean()) if valid.any() else None


def breakdowns(out: Dict, batch: Dict, max_disp: int, ld_thresh: float,
               ablated_final: torch.Tensor) -> Dict[str, float]:
    """scripts/report_eval.py:150-255 for one batch: each breakdown's value
    (NaN where its pixel set is empty) from the forward's outputs `out`,
    the sparse-ablated final prediction and the batch's ground truth (and
    right masks, for `cand_avail`); `mask_density` is the mean of the
    final stage's mask."""
    gt = batch["gt"].float()
    res: Dict[str, float] = {}
    in_range = (gt > 0) & (gt < max_disp)
    err = {k: (out[k][-1].float() - gt).abs()
           for k in ("dense", "sparse", "fusion", "sparse_raw") if out[k]}
    fine = bool(out["sparse"]) and bool(out["masks_used"])
    if fine:
        m = out["masks_used"][-1] > 0
        valid = in_range & m
        cand = out["cand"][-1] > 0
        for k, e in err.items():
            res[f"mask_{k}"] = _masked_mean(e, valid)
            res[f"mask_{k}_cand"] = _masked_mean(e, valid & cand)
            res[f"mask_{k}_nocand"] = _masked_mean(e, valid & ~cand)
        res["cand_avail_exact"] = _masked_mean(cand, valid)
        derr, serr = err["dense"], err["sparse"]
        res["mask_oracle"] = _masked_mean(torch.minimum(derr, serr), valid)
        soft = out["soft_mask"][-1].float()
        swin = valid & (serr < derr)
        res["soft_mask_where_sparse_wins"] = _masked_mean(soft, swin)
        res["soft_mask_where_dense_wins"] = _masked_mean(
            soft, valid & ~(serr < derr))
        res["sparse_win_frac"] = (float(swin.float().sum())
                                  / max(float(valid.float().sum()), 1.0))
        res["mask_density"] = float(out["masks_used"][-1].float().mean())
        if batch.get("right_masks") is not None:
            avail = cand_avail(out["masks_used"][-1], gt,
                               batch["right_masks"][-1])
            if avail is not None:
                res["cand_avail"] = avail
    vld = in_range & lost_detail_mask(gt, ld_thresh)
    res["ld_frac"] = float(vld.float().mean())
    res["ld_final"] = _masked_mean((out["preds"][-1].float() - gt).abs(),
                                   vld)
    res["ld_ablate"] = _masked_mean((ablated_final.float() - gt).abs(), vld)
    if fine:
        mfin = out["masks_used"][-1] > 0
        vldm = vld & mfin
        for k in ("dense", "sparse", "fusion"):
            res[f"ld_{k}"] = _masked_mean(err[k], vld)
        res["ld_mask_frac_of_ld"] = _masked_mean(mfin, vld)
        for k in ("dense", "sparse", "fusion"):
            res[f"ld_mask_{k}"] = _masked_mean(err[k], vldm)
        vldc = vldm & cand
        res["ld_cand_frac_of_mask"] = _masked_mean(cand, vldm)
        for k in ("dense", "sparse", "fusion"):
            res[f"ld_cand_{k}"] = _masked_mean(err[k], vldc)
    return res


@torch.no_grad()
def report(ckpt: str, *, h: int, w: int, max_disp: int, batch: int,
           batches: int, seed: int = 37, variant: str = "default",
           device="cuda", draws: Optional[str] = None,
           exec_s2d: bool = False, s2d: bool = False,
           use_detail: bool = False, thold: float = 0.9,
           thold_mode: Optional[str] = None,
           detail_density: Optional[float] = None,
           ld_thresh: float = 9.0) -> Dict:
    """The report of `ckpt` on `batches` val batches (see the module
    docstring), of the saved scenes `draws` if given; `exec_s2d` runs a
    faithful checkpoint through its exact s2d twin."""
    dev = resolve_device(device)
    dtype = "bfloat16" if dev.type == "cuda" else "float32"
    knobs = {"thold": thold}
    if thold_mode is not None:
        knobs["thold_mode"] = thold_mode
    if detail_density is not None:
        knobs["detail_density"] = detail_density
    model = load_model(ckpt, dev, s2d=s2d, use_detail=use_detail,
                       max_disp=max_disp, dtype=dtype, **knobs)
    s2d = model.cfg.s2d_fine            # the checkpoint's own form
    if exec_s2d and not s2d:
        model = s2d_exec_model(model)
    cfg = model.cfg
    stream = (saved_draw_stream(draws, seed=seed, batch=batch, h=h, w=w,
                                max_disp=max_disp, dtype=cfg.torch_dtype,
                                device=dev, variant=variant) if draws else
              device_batch_stream(seed, val=True, batch=batch, h=h, w=w,
                                  max_disp=max_disp, dtype=cfg.torch_dtype,
                                  device=dev, variant=variant))
    acc: Dict[str, List] = {}

    def add(key, pred, gt, md):
        acc.setdefault(key, []).append(
            tuple(float(x) for x in epe_and_d1(pred, gt, md)))

    t0 = time.perf_counter()
    for bi in range(batches):
        b = next(stream, None)
        if b is None:
            raise ValueError(f"{draws} holds {bi} batches, not {batches}")
        gt = b["gt"]
        args = (b["left"], b["right"], b["left_masks"], b["right_masks"])
        out = model(*args)
        ablated = model(*args, ablate_sparse=True)["preds"][-1]
        add("ablate_sparse_final", ablated, gt, max_disp)
        for i, pred in enumerate(out["preds"]):
            sc = gt.shape[1] // pred.shape[1]
            g = gt[:, ::sc, ::sc] / sc if sc > 1 else gt
            add(f"stage{i}", pred, g, max_disp // max(sc, 1))
        coarse = out["preds"][0]
        up = interpolate((coarse * (gt.shape[1] / coarse.shape[1]))[:, None],
                         gt.shape[1], gt.shape[2], "bicubic")[:, 0]
        add("up0_baseline", up, gt, max_disp)
        for k in ("dense", "fusion"):
            add(f"final_{k}", out[k][-1], gt, max_disp)
        for k, v in breakdowns(out, b, max_disp, ld_thresh, ablated).items():
            acc.setdefault(k, []).append((v, 0.0))
    seconds = time.perf_counter() - t0

    meta = os.path.join(ckpt, "meta.json")
    rep = {"step": 0, "s2d": s2d, "use_detail": cfg.use_detail,
           "batches": batches, "exec_s2d": bool(exec_s2d and not s2d)}
    if os.path.exists(meta):
        with open(meta) as f:
            rep["step"] = json.load(f).get("step")
    if cfg.use_detail:
        rep.update(thold_mode=cfg.thold_mode, thold=cfg.thold)
        if cfg.thold_mode == "quantile":
            rep["detail_density_target"] = cfg.detail_density
    density = acc.pop("mask_density", None)
    for k, vals in acc.items():
        # a batch whose pixel set was empty (NaN) does not count; null
        # when every batch's was
        for j, suffix in enumerate(("_epe", "_d1")):
            fin = [v[j] for v in vals if math.isfinite(v[j])]
            rep[k + suffix] = float(np.mean(fin)) if fin else None
    if density:
        rep["mask_density"] = float(np.mean([v for v, _ in density]))
    last = f"stage{len(out['preds']) - 1}"
    rep["decomposition_win_epe"] = rep["up0_baseline_epe"] - rep[f"{last}_epe"]
    rep["sparse_contribution_epe"] = (rep["ablate_sparse_final_epe"]
                                      - rep[f"{last}_epe"])
    per = [e for e, _ in acc[last]]
    rep["final_epe_per_batch"] = per
    rep["final_epe_se"] = (float(np.std(per, ddof=1)) / math.sqrt(len(per))
                           if len(per) > 1 else None)
    rep["shape"] = [h, w, max_disp]
    rep["variant"] = variant
    rep["ld_thresh"] = ld_thresh
    rep["draws"] = draws
    rep["dtype"] = dtype
    rep["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    rep["seconds"] = seconds
    return rep


def main(argv=None):
    a = parse_args(argv)
    rep = report(a.ckpt, h=a.h, w=a.w, max_disp=a.max_disp, batch=a.batch,
                 batches=a.batches, seed=a.seed, variant=a.variant,
                 device=a.device, draws=a.draws, exec_s2d=bool(a.exec_s2d),
                 s2d=a.s2d, use_detail=a.use_detail, thold=a.thold,
                 thold_mode=a.thold_mode, detail_density=a.detail_density,
                 ld_thresh=a.ld_thresh)
    print(json.dumps(rep, indent=2))
    if a.json:
        with open(a.json, "w") as f:
            json.dump(rep, f, indent=2)


if __name__ == "__main__":
    main()
