"""Where a served request's or a training step's time goes on the card.

--mode serve (default): loads a checkpoint (any committed one), serves one
warm-up and then three seeded synthetic 540x972 requests through
`request_masks` and `predict`.
--mode train: prepares the train CLI's run from the checkpoint and its
config.json (any committed one: the faithful, s2d, window and detail
recipes; batch 8 of 162x486 crops of the on-device stream), takes one
warm-up step and then three steps (its checkpoint directory, under the
build directory, is never written, so nothing is resumed); `--set`
overrides go to the train CLI, e.g. `--set train.freeze_bn=1 --set
train.packed_exec=1` for the packed frozen-BN step.
The measured part runs under torch.profiler (`utils/profiling.py::
device_trace`, each request or step a named range by `annotate`; the
Chrome trace goes to the build directory's `profile_trace/trace.json`);
printed are the wall time per request (step), the device time of the top
kernels, the device's busy share of the window, and one JSON summary
line.  The device-time sums come from CUPTI, as `key_averages()` reports
them.

Usage:
  python -m decnet_tpu_torch.cli.profile [--mode serve|train]
      [--resume runs/ckpt_faithful] [--set SECTION.KEY=VALUE ...]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from decnet_tpu_torch.cli import train as train_cli
from decnet_tpu_torch.cli.demo import predict, request_masks
from decnet_tpu_torch.data.synthetic import synthetic_pair
from decnet_tpu_torch.device import resolve_device
from decnet_tpu_torch.ops.kernels.build import BUILD_DIR
from decnet_tpu_torch.utils.profiling import annotate, device_trace
from decnet_tpu_torch.weights import load_checkpoint

SIZE = (540, 972, 216)      # SceneFlow's 540x960 padded to x27, max_disp
PORT_KERNELS = ("moments_kernel", "warp_kernel", "dref_kernel",
                "dtar_kernel")
REQUESTS, SEED, TOP = 3, 0, 30


def _device_us(evt) -> float:
    """Device time of a kernel or copy event (0 for host-side ops and for
    user-annotated ranges such as Optimizer.step, whose device time is
    their kernels' and would count them twice)."""
    if (evt.device_type != torch.autograd.DeviceType.CUDA
            or getattr(evt, "is_user_annotation", False)):
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _serve_work(resume, dev, overrides=()):
    """(warm-up, measured work, label) of serving."""
    model = load_checkpoint(resume, device=dev)
    H, W, D = SIZE
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    reqs = [synthetic_pair(H, W, gen, dev) for _ in range(REQUESTS + 1)]

    def serve(left, right):
        masks = request_masks(left, right, model.cfg)
        predict(model, left, right, *masks, D)

    def warm():
        serve(reqs[0][0], reqs[0][1])

    def work():
        for i, (left, right, _, _) in enumerate(reqs[1:]):
            with annotate(f"request {i}"):
                serve(left, right)
    return warm, work, f"requests {H}x{W} max_disp {D}"


def _train_work(resume, dev, overrides=()):
    """(warm-up, measured work, label) of training steps."""
    run = train_cli.prepare(["--config", os.path.join(resume, "config.json"),
                             "--dataset", "synthetic", "--init_from", resume,
                             "--ckpt_dir", str(BUILD_DIR / "profile_ckpt"),
                             "--device", str(dev)]
                            + [a for ov in overrides for a in ("--set", ov)])
    batches = [next(run.stream) for _ in range(REQUESTS + 1)]
    t = run.cfg.train

    def warm():
        run.step(batches[0])

    def work():
        for i, b in enumerate(batches[1:]):
            with annotate(f"step {i}"):
                run.step(b)
    return warm, work, (f"train steps B={t.batch_size} {t.crop_h}x{t.crop_w}"
                        f" max_disp {run.cfg.model.max_disp}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", choices=("serve", "train"), default="serve")
    p.add_argument("--resume", default="runs/ckpt_faithful")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="SECTION.KEY=VALUE",
                   help="train mode: a config override for the train CLI")
    args = p.parse_args(argv)

    dev = resolve_device("cuda")
    if args.overrides and args.mode != "train":
        raise ValueError("--set applies to --mode train")
    make = _serve_work if args.mode == "serve" else _train_work
    warm, work, label = make(args.resume, dev, args.overrides)
    warm()
    torch.cuda.synchronize()

    with device_trace(str(BUILD_DIR / "profile_trace")) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    rows = [(e.key, e.count, _device_us(e) / 1e3)
            for e in prof.key_averages() if _device_us(e) > 0]
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    port_ms = sum(r[2] for r in rows if any(k in r[0] for k in PORT_KERNELS))
    n = REQUESTS
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"{n} {label}: wall {wall_ms / n:.3f} ms each, device busy "
          f"{device_ms / n:.3f} ms each ({100 * device_ms / wall_ms:.1f}% of "
          f"the window), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB")
    for name, calls, ms in rows[:TOP]:
        print(f"  {ms / n:9.4f} ms each  {calls // n:5d} calls each  "
              f"{100 * ms / device_ms:5.1f}%  {name[:90]}")
    print(json.dumps({"mode": args.mode, "wall_ms_per_unit": wall_ms / n,
                      "device_ms_per_unit": device_ms / n,
                      "busy_share": device_ms / wall_ms,
                      "port_kernels_ms_per_unit": port_ms / n,
                      "device_events_per_unit":
                          sum(r[1] for r in rows) / n}))


if __name__ == "__main__":
    main()
