"""Folder-based inference CLI — the port of decnet_tpu/cli/demo.py.

For each scene directory under --root holding im0.png/im1.png (and an
optional calib.txt with ndisp): pad to x27, compute the detail masks on the
device, normalise, run DecNet, crop back, and write `<scene>.png` (uint16,
disparity * 256) into --save2where.

Usage:
  python -m decnet_tpu_torch.cli.demo --root InputData/Sceneflow \
      --save2where out/ [--resume runs/ckpt_faithful] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from decnet_tpu_torch.data import io as dio
from decnet_tpu_torch.models.decnet import DecNet
from decnet_tpu_torch.ops.detail import detail_masks
from decnet_tpu_torch.weights import load_checkpoint

MASK_THOLD = 0.3      # the demo's precomputed-mask threshold
PAD_MULTIPLE = 27


@torch.no_grad()
def predict(model: DecNet, left: torch.Tensor, right: torch.Tensor,
            max_disp: int, mask_thold: float = MASK_THOLD) -> torch.Tensor:
    """Disparity (B,H,W) f32 for a stereo pair (B,3,H,W) in [0,1] on the
    model's device: pad to x27, detail masks, normalise, forward, crop."""
    cfg = model.cfg
    h, w = left.shape[-2:]
    lp = dio.pad_to_multiple(left.float(), PAD_MULTIPLE)
    rp = dio.pad_to_multiple(right.float(), PAD_MULTIPLE)
    levels = cfg.num_stage - 1
    lmasks = detail_masks(lp, cfg.down_scale, levels, mask_thold)
    rmasks = detail_masks(rp, cfg.down_scale, levels, mask_thold)
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
        t0 = time.perf_counter()
        pred = predict(model, left, right, int(ndisp), args.mask_thold)
        pred = pred[0].cpu().numpy()     # waits for the device
        dt = time.perf_counter() - t0
        dio.write_submission_png(os.path.join(args.save2where, name + ".png"),
                                 pred)
        print(f"{name}: {left.shape[2]}x{left.shape[3]} ndisp={ndisp} "
              f"cost time: {dt:.3f}s")


if __name__ == "__main__":
    main()
