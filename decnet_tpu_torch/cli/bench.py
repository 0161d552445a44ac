"""Serving throughput on the card: stereo pairs per second of the whole
DecNet forward — the port of the root `bench.py` (the JAX package's
benchmark, which stays as it is).

The inputs are bench.py's: 4 synthetic pairs at 540x972 (`data/
synthetic.py::make_pair`, RandomState(0), max_disp 192), their detail
masks computed on the host (`data/masks.py::stereo_pair_masks`, thold
0.3), made outside the timer; the images enter in [0, 1], unnormalised,
as there.  The configuration is bench.py's: max_disp 216, base 8, 4
stages, `cor`, masks from the caller (use_detail False), bf16; its
execution keys `conv3d_impl` and `split_concat` are accepted and skipped,
as every config of the port does.  Three variants, all from the weights
`torch.manual_seed(0)` draws for the faithful model:
  s2d            a fresh s2d model (s2d_fine, s2d_stages 2), the headline;
  faithful       the faithful weights through the exact repack
                 (`models/repack.py::repack_faithful_to_s2d`, stages 2);
  faithful_nhwc  the faithful weights run in faithful form.
Each is timed chained, as bench.py times it: a call's left input is
`left + carry * 1e-12`, carry the previous call's mean disparity; two
warm-up calls, then 2 rounds of 15 calls under `torch.inference_mode()`
with the scalar read back inside the timer; pairs/s is the best round's,
and both rounds are printed beside it.

Prints one JSON line with bench.py's keys (and the rounds, peak memory,
and the sparse-matching and warp kernels' launches a forward, per
variant).  `mfu_ref_pct` / `mfu_packed_pct` are printed only for a card
whose dense bf16 peak is known here (`PEAK_BF16_TFLOPS`).  `--device cpu`
mirrors bench.py's CPU mode: 54x108, B=1, f32, 2 calls a round, the
faithful_nhwc variant only.

Usage:
  python -m decnet_tpu_torch.cli.bench [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from decnet_tpu_torch.config import Config, ModelConfig
from decnet_tpu_torch.data.masks import stereo_pair_masks
from decnet_tpu_torch.data.synthetic import make_pair
from decnet_tpu_torch.device import resolve_device
from decnet_tpu_torch.models.decnet import DecNet
from decnet_tpu_torch.models.repack import s2d_exec_model
from decnet_tpu_torch.ops.kernels import spamat
from decnet_tpu_torch.ops.kernels import warp as kwarp

# bench.py's reference anchors, kept as the port's own copies: a 20 pairs/s
# estimate of the reference on its GPU, and the reference model's FLOPs a
# pair at 540x972 / 216 (scripts/ref_flops.py)
REFERENCE_PAIRS_PER_SEC_ESTIMATE = 20.0
REFERENCE_FLOPS_PER_PAIR_G = 172.43
# dense bf16 peak, TFLOP/s, keyed by a part of torch.cuda.get_device_name:
# the H100 SXM5 (HBM3) card
PEAK_BF16_TFLOPS = {"H100 80GB HBM3": 989.4}
VARIANTS = ("s2d", "faithful", "faithful_nhwc")
CARD = dict(H=540, W=972, batch=4, dtype="bfloat16", iters=15)
CPU = dict(H=54, W=108, batch=1, dtype="float32", iters=2)
CPU_VARIANTS = ("faithful_nhwc",)
ROUNDS = 2


def make_inputs(H: int, W: int, batch: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor],
                           List[torch.Tensor], float]:
    """bench.py's pairs and host masks: (left, right) (B,3,H,W) in [0,1],
    (left, right) masks coarsest first (B,h,w), and the full-resolution
    left masks' mean density."""
    rng = np.random.RandomState(0)
    lefts, rights, lmasks, rmasks = [], [], [], []
    for _ in range(batch):
        pair = make_pair(rng, H, W, max_disp=192)
        lf = pair["left"].astype(np.float32) / 255.0
        rt = pair["right"].astype(np.float32) / 255.0
        lm, rm = stereo_pair_masks(lf, rt, scale=3, levels=3, thold=0.3)
        lefts.append(lf)
        rights.append(rt)
        lmasks.append(lm)
        rmasks.append(rm)

    def images(xs):
        return torch.from_numpy(np.stack(xs)).permute(0, 3, 1, 2) \
            .contiguous().to(device)

    def masks(ms):
        return [torch.from_numpy(np.stack([m[i] for m in ms])).to(device)
                for i in range(3)]
    density = float(np.mean([m[-1].mean() for m in lmasks]))
    return images(lefts), images(rights), masks(lmasks), masks(rmasks), \
        density


def bench_config(mode: str, dtype: str) -> ModelConfig:
    """bench.py:101-110's ModelConfig for a variant."""
    return Config.from_dict({"model": dict(
        max_disp=216, base_channels=8, num_stage=4, down_scale=3,
        cost_func="cor", use_detail=False,
        s2d_fine=mode != "faithful_nhwc", s2d_stages=2, dtype=dtype,
        matching_impl="auto", conv3d_impl="shift2d",
        split_concat=True)}).model


def build_variant(mode: str, dtype: str, device) -> DecNet:
    """The variant's model, filled, in eval mode on `device`."""
    if mode not in VARIANTS:
        raise ValueError(f"variant {mode!r}: one of {VARIANTS}")
    cfg = bench_config(mode, dtype)
    torch.manual_seed(0)
    if mode == "s2d":
        model = DecNet(cfg)
    else:
        model = DecNet(bench_config("faithful_nhwc", dtype)).eval()
        if mode == "faithful":
            model = s2d_exec_model(model, stages=2)
    return model.to(device).eval()


def count_flops(model: DecNet, inputs) -> float:
    """FLOPs of one forward by `torch.utils.flop_counter.FlopCounterMode`:
    the convolutions and matrix products torch dispatches.  The port's
    CUDA kernels (sparse matching, warp) and all elementwise work are not
    counted, so this is below XLA's cost analysis, which bench.py reads."""
    from torch.utils.flop_counter import FlopCounterMode
    left, right, lm, rm = inputs
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        model(left, right, lm, rm)
    return float(counter.get_total_flops())


def time_variant(model: DecNet, inputs, iters: int) -> Dict:
    """bench.py's chained timing of `model` on `inputs` (module
    docstring): pairs/s of the best round and of each, the final carry,
    peak memory, the kernels' launches over the timed calls, and "pred",
    the first warm-up call's final disparity (its carry is 0, so its input
    is `inputs` as given)."""
    left, right, lm, rm = inputs
    dev = left.device
    batch = left.shape[0]

    def forward(carry):
        return model(left + carry * 1e-12, right, lm, rm)["preds"][-1]

    flops = count_flops(model, inputs)
    with torch.inference_mode():
        pred = forward(torch.zeros((), device=dev)).float()
        carry = forward(pred.mean()).mean()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        n0 = (spamat.moments.launches, kwarp.warp.launches)
        rounds = []
        for _ in range(ROUNDS):
            t0 = time.perf_counter()
            for _ in range(iters):
                carry = forward(carry).mean()
            final = float(carry)            # the readback fences the round
            rounds.append(batch * iters / (time.perf_counter() - t0))
    if not np.isfinite(final):
        raise FloatingPointError(f"the chained mean disparity is {final}")
    forwards = ROUNDS * iters
    return {"pairs_per_sec": max(rounds), "rounds_pairs_per_sec": rounds,
            "flops_per_pair": flops / batch, "final": final,
            "peak_mem_mb": (torch.cuda.max_memory_allocated(dev) / 2 ** 20
                            if dev.type == "cuda" else None),
            "forwards": forwards, "pred": pred,
            "launches": {"spamat_moments": spamat.moments.launches - n0[0],
                         "warp": kwarp.warp.launches - n0[1]}}


def peak_tflops(kind: str):
    return next((v for k, v in PEAK_BF16_TFLOPS.items() if k in kind), None)


def run(device="cuda") -> Dict:
    """Measures the three variants in bench.py's order on the card (s2d,
    the headline, then faithful and faithful_nhwc), or faithful_nhwc
    alone on the CPU; returns the JSON record and, under "variants", each
    variant's `time_variant` result."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    shape = CARD if on_card else CPU
    H, W, batch, dtype = (shape[k] for k in ("H", "W", "batch", "dtype"))
    inputs = make_inputs(H, W, batch, dev)
    density = inputs[-1]
    inputs = inputs[:4]
    modes = VARIANTS if on_card else CPU_VARIANTS
    res = {}
    for mode in modes:
        model = build_variant(mode, dtype, dev)
        res[mode] = time_variant(model, inputs, shape["iters"])
        del model
        if on_card:
            torch.cuda.empty_cache()
    head = res[modes[0]]
    # bench.py's CPU mode times one variant and reports it under every key
    faithful, nhwc = ((res["faithful"], res["faithful_nhwc"]) if on_card
                      else (head, head))
    pps, flops_pair = head["pairs_per_sec"], head["flops_per_pair"]
    tflops = pps * flops_pair / 1e12
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    out = {
        "metric": "pairs_per_sec",
        "value": round(pps, 3),
        "unit": f"stereo pairs/s ({H}x{W}, B={batch}, max_disp 216, "
                f"{dtype}, {modes[0]}, precomputed masks density "
                f"{density:.2f}, reference matching semantics "
                f"(match_window=0, no cand_fallback), 1 "
                f"{'card' if on_card else 'host'}, backend={dev.type}, "
                f"{kind})",
        "vs_baseline": round(pps / REFERENCE_PAIRS_PER_SEC_ESTIMATE, 3),
        "faithful_pairs_per_sec": round(faithful["pairs_per_sec"], 3),
        "faithful_nhwc_pairs_per_sec": round(nhwc["pairs_per_sec"], 3),
        "flops_per_pair_G": round(flops_pair / 1e9, 2),
        "faithful_flops_per_pair_G": round(faithful["flops_per_pair"] / 1e9,
                                           2),
        "achieved_tflops_per_sec": round(tflops, 3),
        "reference_flops_per_pair_G": REFERENCE_FLOPS_PER_PAIR_G,
        "ref_equiv_tflops_per_sec": round(
            pps * REFERENCE_FLOPS_PER_PAIR_G / 1e3, 3),
        "device_kind": kind,
        "rounds_pairs_per_sec": {m: [round(x, 3) for x in r[
            "rounds_pairs_per_sec"]] for m, r in res.items()},
        "peak_mem_mb": {m: r["peak_mem_mb"] and round(r["peak_mem_mb"], 1)
                        for m, r in res.items()},
        "launches_per_forward": {m: {k: n / r["forwards"]
                                     for k, n in r["launches"].items()}
                                 for m, r in res.items()},
    }
    peak = peak_tflops(kind) if on_card else None
    if peak:
        out["mfu_ref_pct"] = round(
            100.0 * (pps * REFERENCE_FLOPS_PER_PAIR_G / 1e3) / peak, 2)
        out["mfu_packed_pct"] = round(100.0 * tflops / peak, 2)
    return {"record": out, "variants": res}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    result = run(args.device)
    print(json.dumps(result["record"]), flush=True)
    return result


if __name__ == "__main__":
    main()
