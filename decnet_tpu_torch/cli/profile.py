"""Where a served request's time goes on the card.

Loads a checkpoint, serves one warm-up and then three seeded synthetic
540x972 requests through `predict` under torch.profiler, and prints the
wall time per request, the device time of the top kernels, the device's
busy share of the window, and one JSON summary line.  The device-time sums
come from CUPTI, as `key_averages()` reports them.

Usage:
  python -m decnet_tpu_torch.cli.profile [--resume runs/ckpt_faithful]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from decnet_tpu_torch.cli.demo import predict
from decnet_tpu_torch.data.synthetic import synthetic_pair
from decnet_tpu_torch.device import resolve_device
from decnet_tpu_torch.weights import load_checkpoint

SIZE = (540, 972, 216)      # SceneFlow's 540x960 padded to x27, max_disp
PORT_KERNELS = ("moments_kernel", "warp_kernel")
REQUESTS, SEED, TOP = 3, 0, 30


def _device_us(evt) -> float:
    """Device time of a kernel or copy event (0 for host-side ops, whose
    device time is their kernels' and would count them twice)."""
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--resume", default="runs/ckpt_faithful")
    args = p.parse_args(argv)

    dev = resolve_device("cuda")
    model = load_checkpoint(args.resume, device=dev)
    H, W, D = SIZE
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    reqs = [synthetic_pair(H, W, gen, dev) for _ in range(REQUESTS + 1)]
    predict(model, reqs[0][0], reqs[0][1], D)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for left, right, _, _ in reqs[1:]:
            predict(model, left, right, D)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    rows = [(e.key, e.count, _device_us(e) / 1e3)
            for e in prof.key_averages() if _device_us(e) > 0]
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    port_ms = sum(r[2] for r in rows if any(k in r[0] for k in PORT_KERNELS))
    n = REQUESTS
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"{n} requests {H}x{W} max_disp {D}: wall {wall_ms / n:.3f} ms "
          f"per request, device busy {device_ms / n:.3f} ms per request "
          f"({100 * device_ms / wall_ms:.1f}% of the window)")
    for name, calls, ms in rows[:TOP]:
        print(f"  {ms / n:9.4f} ms/req  {calls // n:5d} calls/req  "
              f"{100 * ms / device_ms:5.1f}%  {name[:90]}")
    print(json.dumps({"wall_ms_per_request": wall_ms / n,
                      "device_ms_per_request": device_ms / n,
                      "busy_share": device_ms / wall_ms,
                      "port_kernels_ms_per_request": port_ms / n,
                      "kernel_launches_per_request":
                          sum(r[1] for r in rows) / n}))


if __name__ == "__main__":
    main()
