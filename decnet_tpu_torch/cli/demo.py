"""Folder-based inference CLI — the port of decnet_tpu/cli/demo.py.

For each scene directory under --root holding im0.png/im1.png (and an
optional calib.txt with ndisp): pad to x27, compute the detail masks on the
host as the JAX demo does (`--mask_source compute`: `data/masks.py::
detail_masks_np`, the native library; `wavelet`: the pair-consistent
wavelet masks; a model with learned detail heads makes its own and skips
this), normalise, run DecNet, crop back, and write `<scene>.png` (uint16,
disparity * 256) into --save2where.  PNG files are read and written by
`data/io.py`, without PIL or cv2.  Any committed checkpoint serves
(faithful, s2d, windowed, learned detail), and so does a reference `.pkl`
(`cli/common.py`); without --resume the model is a fresh initialisation,
as the JAX demo's is.  --exec_s2d 1 serves a faithful checkpoint through
its exact s2d twin (`models/repack.py::s2d_exec`: the same outputs up to
summation order).  --dump_intermediates 1 also writes `<scene>_check.png`,
the JAX demo's grid of every stage's intermediates (`utils/viz.py::
show_imgs`: every stage's prediction, then the dense, sparse, fusion, soft
mask and variance maps of each fine stage, then the masks used in gray;
4 columns, at the padded size), with its panels' titles in
`<scene>_check.json`; the submission PNG is the same with or without it.

Usage:
  python -m decnet_tpu_torch.cli.demo --root InputData/Sceneflow \
      --save2where out/ --resume runs/ckpt_faithful [--exec_s2d 1] \
      [--max_disp 216] [--mask_source compute|wavelet] [--device cuda] \
      [--dump_intermediates 1]
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from decnet_tpu_torch.cli.common import (add_config_args,
                                         apply_checkpoint_sidecar,
                                         build_config, init_model_and_state)
from decnet_tpu_torch.config import ModelConfig
from decnet_tpu_torch.data import io as dio
from decnet_tpu_torch.data import masks as dmasks
from decnet_tpu_torch.models.decnet import DecNet
from decnet_tpu_torch.models.repack import s2d_exec_model
from decnet_tpu_torch.utils.viz import show_imgs

MASK_THOLD = 0.3      # the demo's precomputed-mask threshold
PAD_MULTIPLE = 27


def host_masks(left: torch.Tensor, right: torch.Tensor, cfg: ModelConfig,
               mask_thold: float = MASK_THOLD
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The JAX demo's detail masks of a stereo pair (B,3,H,W) in [0,1]:
    padded to x27 as `predict` pads it and computed on the host, all images
    at once (one thread each).  Returns (left, right) lists of (B,h,w) f32
    masks, coarsest first, on the images' device."""
    pair = torch.cat([left, right]).float()
    imgs = dio.pad_to_multiple(pair, PAD_MULTIPLE).permute(0, 2, 3, 1)
    per = dmasks.detail_masks_batch(imgs.cpu().numpy(), cfg.down_scale,
                                    cfg.num_stage - 1, mask_thold)
    levels = [torch.from_numpy(np.stack(lv)).to(left.device)
              for lv in zip(*per)]
    B = left.shape[0]
    return [m[:B] for m in levels], [m[B:] for m in levels]


def wavelet_masks(left: torch.Tensor, right: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The JAX demo's wavelet masks of one stereo pair (1,3,H,W) in [0,1]
    (`data/masks.py::wavelet_pair_masks_np`, thresholds shared by the
    pair), padded as `predict` pads it: (left, right) lists of (1,h,w) f32
    masks, coarsest first, on the images' device."""
    lp, rp = (dio.pad_to_multiple(x.float(), PAD_MULTIPLE)[0]
              .permute(1, 2, 0).cpu().numpy() for x in (left, right))
    lms, rms = dmasks.wavelet_pair_masks_np(lp, rp, cfg.down_scale,
                                            cfg.num_stage - 1)
    to = lambda ms: [torch.from_numpy(m)[None].to(left.device) for m in ms]
    return to(lms), to(rms)


def request_masks(left: torch.Tensor, right: torch.Tensor, cfg: ModelConfig,
                  mask_thold: float = MASK_THOLD,
                  mask_source: str = "compute"):
    """The masks a request needs: `host_masks` (`wavelet_masks` for
    mask_source "wavelet"), or (None, None) for a model whose learned
    detail heads make them."""
    if cfg.use_detail:
        return None, None
    if mask_source == "wavelet":
        return wavelet_masks(left, right, cfg)
    return host_masks(left, right, cfg, mask_thold)


@torch.no_grad()
def predict(model: DecNet, left: torch.Tensor, right: torch.Tensor,
            lmasks: Optional[Sequence[torch.Tensor]],
            rmasks: Optional[Sequence[torch.Tensor]],
            max_disp: int, full: bool = False):
    """Disparity (B,H,W) f32 for a stereo pair (B,3,H,W) in [0,1] on the
    model's device and its padded images' detail masks (`request_masks`):
    pad to x27, normalise, forward, crop.  With `full`, (disparity, the
    forward's output dict at the padded size)."""
    h, w = left.shape[-2:]
    lp = dio.pad_to_multiple(left.float(), PAD_MULTIPLE)
    rp = dio.pad_to_multiple(right.float(), PAD_MULTIPLE)
    out = model(dio.normalize_image(lp), dio.normalize_image(rp),
                lmasks, rmasks, max_disp=max_disp)
    pred = out["preds"][-1][:, -h:, -w:]
    return (pred, out) if full else pred


def intermediate_panels(out) -> List[tuple]:
    """The JAX demo's grid panels of sample 0 of a forward's outputs, in
    its order: (map, title[, cmap])."""
    first = lambda x: x[0].float().cpu().numpy()
    panels = [(first(p), f"pred s{i}") for i, p in enumerate(out["preds"])]
    panels += [(first(x), f"{nm} s{i + 1}")
               for nm in ("dense", "sparse", "fusion", "soft_mask", "var")
               for i, x in enumerate(out[nm])]
    panels += [(first(m), f"mask s{i + 1}", "gray")
               for i, m in enumerate(out["masks_used"])]
    return panels


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_config_args(p)
    p.add_argument("--root", required=True)
    p.add_argument("--save2where", required=True)
    p.add_argument("--mask_thold", type=float, default=MASK_THOLD)
    p.add_argument("--mask_source", default="compute",
                   choices=("compute", "wavelet"))
    p.add_argument("--exec_s2d", type=int, default=0,
                   help="run a faithful checkpoint through the exact "
                   "space-to-depth repack: same outputs, s2d execution")
    p.add_argument("--dump_intermediates", type=int, default=0,
                   help="also write <scene>_check.png, a grid of every "
                   "stage's outputs (titles in <scene>_check.json)")
    args = p.parse_args(argv)

    cfg = apply_checkpoint_sidecar(build_config(args), args)
    model, _ = init_model_and_state(cfg, args.resume, device=args.device)
    if args.exec_s2d and not cfg.model.s2d_fine:
        model = s2d_exec_model(model)
    dev = next(model.parameters()).device
    os.makedirs(args.save2where, exist_ok=True)
    scenes = sorted(d for d in os.listdir(args.root)
                    if os.path.isdir(os.path.join(args.root, d)))
    for name in scenes:
        sdir = os.path.join(args.root, name)

        def load(fname):
            img = dio.read_image(os.path.join(sdir, fname))
            return (torch.from_numpy(img).to(dev).permute(2, 0, 1)[None]
                    .float() / 255.0)

        left, right = load("im0.png"), load("im1.png")
        ndisp = (dio.read_calib_ndisp(os.path.join(sdir, "calib.txt"))
                 or cfg.model.max_disp)
        lmasks, rmasks = request_masks(left, right, model.cfg,
                                       args.mask_thold, args.mask_source)
        t0 = time.perf_counter()
        if args.dump_intermediates:
            pred, out = predict(model, left, right, lmasks, rmasks,
                                int(ndisp), full=True)
        else:
            pred = predict(model, left, right, lmasks, rmasks, int(ndisp))
        pred = pred[0].cpu().numpy()     # waits for the device
        dt = time.perf_counter() - t0
        if args.dump_intermediates:
            show_imgs(intermediate_panels(out), ncols=4,
                      save_path=os.path.join(args.save2where,
                                             name + "_check.png"))
        dio.write_submission_png(os.path.join(args.save2where, name + ".png"),
                                 pred)
        print(f"{name}: {left.shape[2]}x{left.shape[3]} ndisp={ndisp} "
              f"cost time: {dt:.3f}s")
    print("The testing is completed:", time.strftime("%Y-%m-%d %H:%M:%S"))


if __name__ == "__main__":
    main()
