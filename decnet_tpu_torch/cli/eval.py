"""Dataset evaluation / submission CLI — the port of decnet_tpu/cli/eval.py.

--is_eval 1: per batch and over the split, the mean EPE and loss_3 (the
percentage of pixels off by >= 3 px and >= 5%), each sample over its own
valid range 0 < gt < ndisp.  --is_eval 0: a uint16 submission PNG per
sample (disparity * 256, cropped to the image's own size).

Each batch runs at max_disp = the largest ndisp of its samples, rounded up
to a multiple of 27 (Middlebury's per-scene ranges; SceneFlow's 192 gives
216).  --exec_s2d 1 runs a faithful checkpoint through its exact s2d
twin (`models/repack.py::s2d_exec`).  A batch whose forward raises is written to
`<save2where>/Errors/batch<i>.npz` before the error propagates.  The
checkpoint (`--resume`) is a params.npz directory, a port training
directory or a reference .pkl (`cli/common.py`).

Usage:
  python -m decnet_tpu_torch.cli.eval --dataset sceneflow --root /data/sf \\
      --test_split test --batch_size 4 --is_eval 1 \\
      --resume runs/ckpt_faithful [--device cuda]
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict

import numpy as np
import torch

from decnet_tpu_torch.cli.common import (add_config_args,
                                         apply_checkpoint_sidecar,
                                         build_config, init_model_and_state)
from decnet_tpu_torch.data import get_dataset
from decnet_tpu_torch.data import io as dio
from decnet_tpu_torch.data.loader import DataLoader, to_device
from decnet_tpu_torch.models.repack import s2d_exec_model
from decnet_tpu_torch.train.metrics import per_sample_epe_d1

NDISP_ALIGN = 27


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_config_args(p)
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--root", type=str, required=True)
    p.add_argument("--test_split", type=str, default="test")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--is_eval", type=int, default=1)
    p.add_argument("--save2where", type=str, default="eval_out")
    p.add_argument("--mask_source", type=str, default="compute",
                   choices=["compute", "precomputed", "wavelet"])
    p.add_argument("--exec_s2d", type=int, default=0,
                   help="run a faithful checkpoint through the exact "
                   "space-to-depth repack (models/repack.py): same "
                   "outputs, s2d execution")
    return p.parse_args(argv)


def batch_max_disp(n_disps) -> int:
    """The forward's max_disp for a batch: its largest ndisp, rounded up
    to a multiple of 27."""
    return int(math.ceil(max(n_disps) / NDISP_ALIGN) * NDISP_ALIGN)


def dump_batch(err_dir: str, bi: int, batch: Dict) -> str:
    """The host batch's inputs as `<err_dir>/batch<bi>.npz`."""
    os.makedirs(err_dir, exist_ok=True)
    path = os.path.join(err_dir, f"batch{bi}.npz")
    np.savez(path, left=batch["left"], right=batch["right"], gt=batch["gt"],
             **{f"lmask{i}": m for i, m in enumerate(batch["left_masks"])},
             **{f"rmask{i}": m for i, m in enumerate(batch["right_masks"])})
    return path


def main(argv=None) -> Dict:
    """Runs the evaluation; returns per batch `epe`, `d1` (the means of its
    samples), `max_disp` and `seconds`, and `mean_epe` / `mean_d1` over
    the samples (eval mode)."""
    args = parse_args(argv)
    cfg = build_config(args)
    cfg = apply_checkpoint_sidecar(cfg, args)
    model, _ = init_model_and_state(cfg, args.resume, device=args.device)
    if args.exec_s2d and not cfg.model.s2d_fine:
        model = s2d_exec_model(model)
    dev = next(model.parameters()).device

    ds = get_dataset(args.dataset, args.root, split=args.test_split,
                     is_training=False, mask_source=args.mask_source,
                     scale=cfg.model.down_scale,
                     levels=cfg.model.num_stage - 1)
    loader = DataLoader(ds, batch_size=args.batch_size,
                        num_workers=args.num_workers)
    os.makedirs(args.save2where, exist_ok=True)
    err_dir = os.path.join(args.save2where, "Errors")
    res = {"epe": [], "d1": [], "max_disp": [], "seconds": []}
    epes, d1s = [], []
    for bi, batch in enumerate(loader):
        n_disps = [int(x) for x in batch["n_disp"]]
        nd = batch_max_disp(n_disps)
        t0 = time.perf_counter()
        try:
            b = to_device(batch, dev)
            with torch.no_grad():
                pred = model(b["left"], b["right"], b["left_masks"],
                             b["right_masks"], max_disp=nd)["preds"][-1]
            pred_np = pred.float().cpu().numpy()    # waits for the device
        except Exception:
            print(f"batch {bi} failed; inputs dumped to "
                  f"{dump_batch(err_dir, bi, batch)}", flush=True)
            raise
        dt = time.perf_counter() - t0
        res["max_disp"].append(nd)
        res["seconds"].append(dt)
        if args.is_eval:
            b_epes, b_d1s = per_sample_epe_d1(pred.float(), b["gt"], n_disps)
            epes.extend(b_epes)
            d1s.extend(b_d1s)
            res["epe"].append(float(np.mean(b_epes)))
            res["d1"].append(float(np.mean(b_d1s)))
            print(f"batch {bi}: EPE {res['epe'][-1]:.4f}  loss_3 "
                  f"{res['d1'][-1]:.3f}%  max_disp {nd}  ({dt:.3f}s)",
                  flush=True)
        else:
            for i, name in enumerate(batch["name"]):
                dio.write_submission_png(
                    os.path.join(args.save2where, f"{name}.png"), pred_np[i],
                    batch["ori_h"][i], batch["ori_w"][i])
    if args.is_eval and epes:
        res.update(mean_epe=float(np.mean(epes)), mean_d1=float(np.mean(d1s)))
        print(f"MEAN EPE: {res['mean_epe']:.4f}   "
              f"MEAN loss_3: {res['mean_d1']:.3f}%   mean fwd time "
              f"{np.mean(res['seconds'][1:] or res['seconds']):.3f}s",
              flush=True)
    return res


if __name__ == "__main__":
    main()
