"""Accuracy report of a checkpoint on the synthetic validation stream — the
port of scripts/report_eval.py (its per-stage, baseline, ablation and
final-breakdown keys; the mask_*, ld_* and soft_mask_* breakdowns are not
ported).

Per batch of the on-device val stream (`data/device_synth.py`, seed
--seed, --variant): the forward, and again with the sparse branch ablated
(fused = dense).  Reported, each the mean over the batches: EPE and D1 of
every stage's prediction (stage i against the ground truth subsampled to
its resolution), of the ablated final prediction, of stage 0 upsampled
bicubically to full size (the decomposition's baseline), of the final
stage's dense and fused maps; their differences `decomposition_win_epe`
(baseline - final) and `sparse_contribution_epe` (ablated - final); and the
final EPE of each batch with its standard error.  The model config comes
from the checkpoint's config.json; the card computes in bf16, the CPU in
f32, as the JAX script does on TPU and CPU.

Usage:
  python -m decnet_tpu_torch.cli.report_eval --ckpt runs/ckpt_faithful \\
      --h 540 --w 972 --max_disp 216 --batch 4 --batches 24 --seed 37 \\
      --variant legacy [--json out.json] [--device cuda] [--draws s.npz] \
      [--exec_s2d 1]
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

from decnet_tpu_torch.config import VARIANTS
from decnet_tpu_torch.data.device_synth import (device_batch_stream,
                                                saved_draw_stream)
from decnet_tpu_torch.device import resolve_device
from decnet_tpu_torch.models.repack import s2d_exec_model
from decnet_tpu_torch.ops.resize import interpolate
from decnet_tpu_torch.train.metrics import epe_and_d1
from decnet_tpu_torch.weights import load_checkpoint


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ckpt", required=True,
                   help="checkpoint directory (config.json + params.npz)")
    p.add_argument("--h", type=int, default=162)
    p.add_argument("--w", type=int, default=243)
    p.add_argument("--max_disp", type=int, default=108)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--batches", type=int, default=16)
    p.add_argument("--seed", type=int, default=37)
    p.add_argument("--variant", default="default", choices=VARIANTS,
                   help="stream recipe: default (z-buffer right view), "
                   "stressor (thin bars over a periodic texture), legacy "
                   "(the round-4 fixed-point renderer)")
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


@torch.no_grad()
def report(ckpt: str, *, h: int, w: int, max_disp: int, batch: int,
           batches: int, seed: int = 37, variant: str = "default",
           device="cuda", draws: Optional[str] = None,
           exec_s2d: bool = False) -> Dict:
    """The report of `ckpt` on `batches` val batches (see the module
    docstring), of the saved scenes `draws` if given; `exec_s2d` runs a
    faithful checkpoint through its exact s2d twin."""
    dev = resolve_device(device)
    dtype = "bfloat16" if dev.type == "cuda" else "float32"
    model = load_checkpoint(ckpt, device=dev, max_disp=max_disp, dtype=dtype)
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
        acc.setdefault(key, []).append(epe_and_d1(pred, gt, md))

    t0 = time.perf_counter()
    for i in range(batches):
        b = next(stream, None)
        if b is None:
            raise ValueError(f"{draws} holds {i} batches, not {batches}")
        gt = b["gt"]
        args = (b["left"], b["right"], b["left_masks"], b["right_masks"])
        out = model(*args)
        add("ablate_sparse_final", model(*args, ablate_sparse=True)[
            "preds"][-1], gt, max_disp)
        for i, pred in enumerate(out["preds"]):
            s = gt.shape[1] // pred.shape[1]
            g = gt[:, ::s, ::s] / s if s > 1 else gt
            add(f"stage{i}", pred, g, max_disp // max(s, 1))
        coarse = out["preds"][0]
        up = interpolate((coarse * (gt.shape[1] / coarse.shape[1]))[:, None],
                         gt.shape[1], gt.shape[2], "bicubic")[:, 0]
        add("up0_baseline", up, gt, max_disp)
        for k in ("dense", "fusion"):
            add(f"final_{k}", out[k][-1], gt, max_disp)
    seconds = time.perf_counter() - t0

    meta = os.path.join(ckpt, "meta.json")
    rep = {"step": None, "s2d": s2d, "use_detail": cfg.use_detail,
           "batches": batches, "exec_s2d": bool(exec_s2d and not s2d)}
    if os.path.exists(meta):
        with open(meta) as f:
            rep["step"] = json.load(f).get("step")
    if cfg.use_detail:
        rep.update(thold_mode=cfg.thold_mode, thold=cfg.thold)
        if cfg.thold_mode == "quantile":
            rep["detail_density_target"] = cfg.detail_density
    for k, vals in acc.items():
        rep[f"{k}_epe"] = float(np.mean([float(e) for e, _ in vals]))
        rep[f"{k}_d1"] = float(np.mean([float(d) for _, d in vals]))
    last = f"stage{len(out['preds']) - 1}"
    rep["decomposition_win_epe"] = rep["up0_baseline_epe"] - rep[f"{last}_epe"]
    rep["sparse_contribution_epe"] = (rep["ablate_sparse_final_epe"]
                                      - rep[f"{last}_epe"])
    per = [float(e) for e, _ in acc[last]]
    rep["final_epe_per_batch"] = per
    rep["final_epe_se"] = (float(np.std(per, ddof=1)) / math.sqrt(len(per))
                           if len(per) > 1 else None)
    rep["shape"] = [h, w, max_disp]
    rep["variant"] = variant
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
                 device=a.device, draws=a.draws, exec_s2d=bool(a.exec_s2d))
    print(json.dumps(rep, indent=2))
    if a.json:
        with open(a.json, "w") as f:
            json.dump(rep, f, indent=2)


if __name__ == "__main__":
    main()
