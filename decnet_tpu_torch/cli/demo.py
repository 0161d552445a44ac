"""Folder-based inference CLI — the port of decnet_tpu/cli/demo.py.

For each scene directory under --root holding im0.png/im1.png (and an
optional calib.txt with ndisp): pad to x27, compute the detail masks on the
host as the JAX demo does (`data/masks.py::detail_masks_np`, the native
library; a model with learned detail heads makes its own and skips this),
normalise, run DecNet, crop back, and write `<scene>.png` (uint16,
disparity * 256) into --save2where.  Any committed checkpoint serves:
faithful, s2d, windowed, learned detail.

Usage:
  python -m decnet_tpu_torch.cli.demo --root InputData/Sceneflow \
      --save2where out/ [--resume runs/ckpt_faithful] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from decnet_tpu_torch.config import ModelConfig
from decnet_tpu_torch.data import io as dio
from decnet_tpu_torch.data import masks as dmasks
from decnet_tpu_torch.models.decnet import DecNet
from decnet_tpu_torch.weights import load_checkpoint

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


def request_masks(left: torch.Tensor, right: torch.Tensor, cfg: ModelConfig,
                  mask_thold: float = MASK_THOLD):
    """The masks a request needs: `host_masks`, or (None, None) for a
    model whose learned detail heads make them."""
    if cfg.use_detail:
        return None, None
    return host_masks(left, right, cfg, mask_thold)


@torch.no_grad()
def predict(model: DecNet, left: torch.Tensor, right: torch.Tensor,
            lmasks: Optional[Sequence[torch.Tensor]],
            rmasks: Optional[Sequence[torch.Tensor]],
            max_disp: int) -> torch.Tensor:
    """Disparity (B,H,W) f32 for a stereo pair (B,3,H,W) in [0,1] on the
    model's device and its padded images' detail masks (`request_masks`):
    pad to x27, normalise, forward, crop."""
    h, w = left.shape[-2:]
    lp = dio.pad_to_multiple(left.float(), PAD_MULTIPLE)
    rp = dio.pad_to_multiple(right.float(), PAD_MULTIPLE)
    out = model(dio.normalize_image(lp), dio.normalize_image(rp),
                lmasks, rmasks, max_disp=max_disp)
    return out["preds"][-1][:, -h:, -w:]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True)
    p.add_argument("--save2where", required=True)
    p.add_argument("--resume", default="runs/ckpt_faithful",
                   help="checkpoint directory (config.json + params.npz)")
    p.add_argument("--max_disp", type=int, default=0,
                   help="0: the checkpoint's max_disp")
    p.add_argument("--mask_thold", type=float, default=MASK_THOLD)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    model = load_checkpoint(args.resume, device=args.device)
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
                 or args.max_disp or model.cfg.max_disp)
        lmasks, rmasks = request_masks(left, right, model.cfg,
                                       args.mask_thold)
        t0 = time.perf_counter()
        pred = predict(model, left, right, lmasks, rmasks, int(ndisp))
        pred = pred[0].cpu().numpy()     # waits for the device
        dt = time.perf_counter() - t0
        dio.write_submission_png(os.path.join(args.save2where, name + ".png"),
                                 pred)
        print(f"{name}: {left.shape[2]}x{left.shape[3]} ndisp={ndisp} "
              f"cost time: {dt:.3f}s")


if __name__ == "__main__":
    main()
