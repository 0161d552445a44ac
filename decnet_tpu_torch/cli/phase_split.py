"""Where a kernel's time goes inside its blocks, on the card.

Builds the kernels with -DDECNET_STAMPS (csrc/stamps.cuh: clock64 stamps
per block at the phase boundaries each source names in its
`phases(<launcher>): ...` comment), launches each once at the fine-stage
shapes of a 540x972 request (moments, warp) and of a training batch
(moments, warp, dRef, dTar) on 20%-dense random masks and disparities in
[0, max_disp) in bf16, and prints per kernel and
shape the mean cycles per block of each phase, the blocks that reached the
end, and one JSON line with all of it.  The SM clock is measured with a
spin of known length, so cycles convert to microseconds.  The stamps cost
a few instructions and stores per block; the kernels' times are taken
without them by `chip_smoke.py`.

Usage:  python -m decnet_tpu_torch.cli.phase_split [--seed 0] [--out FILE]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re

import numpy as np
import torch

from decnet_tpu_torch.ops.kernels import build, spamat
from decnet_tpu_torch.ops.kernels import warp as kwarp

SERVE_STAGES = [(1, 72, 60, 108, 24), (1, 24, 180, 324, 72),
                (1, 8, 540, 972, 216)]          # (B, C, H, W, D)
TRAIN_STAGES = [(8, 72, 18, 54, 24), (8, 24, 54, 162, 72),
                (8, 8, 162, 486, 216)]
DENSITY = 0.2
SLOTS = 8                                       # kStampSlots
_PHASES = re.compile(r"phases\((\w+)\):\s*(.+)")


def phase_names():
    """{launcher: [phase name of slot 1, 2, ...]} from the sources."""
    names = {}
    for src in sorted(build.CSRC_DIR.glob("*.cu")):
        for m in _PHASES.finditer(src.read_text()):
            names[m.group(1)] = m.group(2).split()
    return names


def sm_clock_hz(dev) -> float:
    """SM cycles per second, from a device spin of known cycles."""
    cycles = 20_000_000
    torch.cuda._sleep(cycles)                   # warm the clocks
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    torch.cuda._sleep(cycles)
    e.record()
    torch.cuda.synchronize(dev)
    return cycles / (s.elapsed_time(e) * 1e-3)


def inputs(gen, B, C, H, W, D, dev):
    rm = (torch.rand(B, H, W, generator=gen, device=dev) < DENSITY).float()
    tm = (torch.rand(B, H, W, generator=gen, device=dev) < DENSITY).float()
    ref = torch.randn(B, C, H, W, generator=gen, device=dev).bfloat16()
    tar = torch.randn(B, C, H, W, generator=gen, device=dev).bfloat16()
    m, se, sed, _ = spamat.moments(ref, tar, rm, tm, D)
    refm = rm != 0
    out = torch.where(refm, (spamat.EPS + sed) / (spamat.EPS + se), 0.0)
    ss = torch.where(refm, spamat.EPS + se, 0.0)
    mc = torch.where(refm, m, 0.0)
    g = torch.randn(B, H, W, generator=gen, device=dev)
    w = spamat.query_weight(g, rm, ss).contiguous()
    disp = torch.rand(B, H, W, generator=gen, device=dev) * D
    return {"spamat_moments": lambda: spamat.moments(ref, tar, rm, tm, D),
            "warp_disparity": lambda: kwarp.warp(ref, disp, D),
            "spamat_dref": lambda: spamat.spamat_dref(ref, tar, tm, mc, out,
                                                      w, D),
            "spamat_dtar": lambda: spamat.spamat_dtar(ref, tar, tm, mc, out,
                                                      w, D)}


def split(stamps: np.ndarray, n_phases: int):
    """Mean cycles per phase over the blocks that stamped every slot."""
    s = stamps[:, :n_phases + 1].astype(np.int64)
    launched = s[:, 0] != 0
    full = launched & (s != 0).all(axis=1)
    d = np.diff(s[full], axis=1)
    return {"blocks": int(launched.sum()), "blocks_full": int(full.sum()),
            "phase_cycles": [float(x) for x in d.mean(axis=0)]
            if full.any() else [],
            "block_cycles": float((s[full, -1] - s[full, 0]).mean())
            if full.any() else 0.0}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("phase_split needs a CUDA card")
    dev = torch.device("cuda")
    build.NVCC_FLAGS = tuple(build.NVCC_FLAGS) + ("-DDECNET_STAMPS",)
    names = phase_names()
    hz = sm_clock_hz(dev)
    print(f"card: {torch.cuda.get_device_name(0)}; SM clock {hz / 1e6:.1f} "
          f"MHz (measured)", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    cases = [("serve", s, ("spamat_moments", "warp_disparity"))
             for s in SERVE_STAGES]
    cases += [("train", s, ("spamat_moments", "warp_disparity",
                            "spamat_dref", "spamat_dtar"))
              for s in TRAIN_STAGES]
    records = []
    for path, (B, C, H, W, D), kernels in cases:
        with torch.no_grad():
            fns = inputs(gen, B, C, H, W, D, dev)
            buf = torch.zeros(B * H * W * SLOTS, dtype=torch.int64,
                              device=dev)
            for name in kernels:
                fns[name]()                      # builds and loads
                for lib in build._LOADED.values():
                    if hasattr(lib, "decnet_stamps_bind"):
                        lib.decnet_stamps_bind.argtypes = [ctypes.c_void_p]
                        if lib.decnet_stamps_bind(buf.data_ptr()) != 0:
                            raise RuntimeError("decnet_stamps_bind failed")
                buf.zero_()
                fns[name]()
                torch.cuda.synchronize(dev)
                phases = names.get(name, [])
                r = split(buf.view(-1, SLOTS).cpu().numpy(), len(phases))
                for lib in build._LOADED.values():
                    if hasattr(lib, "decnet_stamps_bind"):
                        lib.decnet_stamps_bind(None)
                r.update(kernel=name, path=path, shape=[B, C, H, W, D],
                         phases=phases,
                         phase_us=[c / hz * 1e6 for c in r["phase_cycles"]],
                         block_us=r["block_cycles"] / hz * 1e6)
                records.append(r)
                print(f"  {name} {path} B={B} C={C} {H}x{W} D={D}: blocks "
                      f"{r['blocks']} ({r['blocks_full']} full), block "
                      f"{r['block_us']:.3f} us = " + " + ".join(
                          f"{n} {u:.3f}" for n, u in zip(phases,
                                                        r["phase_us"])),
                      flush=True)
    result = {"card": torch.cuda.get_device_name(0), "sm_clock_hz": hz,
              "records": records}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
