#!/usr/bin/env python3
"""Smoke run of the PyTorch port (decnet_tpu_torch) on one NVIDIA card.

Builds the port's CUDA kernels with nvcc, holds each against its plain
PyTorch version on the card at the three fine-stage shapes of one 540x972
request and times both, loads the faithful checkpoint in bf16, serves a few
seeded synthetic stereo requests through `decnet_tpu_torch.cli.demo.predict`
and checks them.  One line is printed per phase as it ends; the line before
the last is a JSON object describing every kernel, the last line is the
device record.  Any failed check ends the run with a non-zero exit.

Usage:  python3 chip_smoke.py [--seed 0] [--out FILE.json]
Needs one CUDA card; without one it exits non-zero and prints no result.
It writes only the kernels' build directory (and --out when given).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "runs", "ckpt_faithful")

# H100 SXM data-sheet peaks (dense): HBM bytes/s and f32 CUDA-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
DEV = "cuda"
# one 540x972 request (SceneFlow's 540x960 padded to x27), max_disp 216
SERVE = (540, 972, 216)
# (C, H, W, D) of the fine stages 1..3 of that request
STAGES = [(72, 60, 108, 24), (24, 180, 324, 72), (8, 540, 972, 216)]
MASK_DENSITY = 0.2
# kernel vs plain tolerances, f32 accumulation both sides:
#   moments: summation order of the C-term scores and of the band differ,
#            which moves each f32 sum by a few ulps: rtol 2e-4 (+1e-6 for
#            sums that underflow towards 0);
#   warp:    both round the same f32 expression; bf16 output may differ
#            by one bf16 ulp (2^-7 relative) where the f32 values differ.
MOMENTS_RTOL, MOMENTS_ATOL = 2e-4, 1e-6
WARP_TOL = {"float32": (0.0, 1e-5), "bfloat16": (2.0 ** -7, 1e-6)}
SERVE_MEAN_TOL = 0.05     # px, kernel path vs plain path, mean |delta|
REQUESTS = 3              # served after one warm-up request
SPIN_CYCLES = 2_000_000   # ~1 ms of device time at H100 clocks


def phase(name, t0, **info):
    fields = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[phase {name}] {time.perf_counter() - t0:.2f}s {fields}",
          flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_cuda(torch, fn, iters, flush_buf):
    """Mean device ms of `fn` over `iters` launches, each after an L2
    flush.  A ~1 ms spin on the card before the start event lets the host
    enqueue `fn` meanwhile, so the events time the device, not the Python
    and launch overhead (which a plain version's many launches still pay)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush_buf.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def candidate_pairs(torch, rm, tm, D):
    """(active query, candidate key) pairs of the band: the work the
    moments kernel does on these masks."""
    W = tm.shape[-1]
    c = torch.nn.functional.pad((tm != 0).double().cumsum(-1), (1, 0))
    w = torch.arange(W, device=tm.device)
    lo = torch.clamp(w - D + 1, min=0)
    cnt = c[..., w + 1] - c[..., lo]
    return float((cnt * (rm != 0)).sum())


def kernel_parity(torch, spamat, kwarp, gen, flush_buf):
    """Each kernel against its plain version at the stage shapes, f32 and
    bf16; times in bf16 (the served dtype).  Returns per-kernel records."""
    F = torch.nn.functional
    dev = DEV
    rec = {"spamat_moments": [], "warp": []}
    for C, H, W, D in STAGES:
        rm = (torch.rand(1, H, W, generator=gen, device=dev)
              < MASK_DENSITY).float()
        tm = (torch.rand(1, H, W, generator=gen, device=dev)
              < MASK_DENSITY).float()
        feat32 = torch.randn(1, C, H, W, generator=gen, device=dev)
        tar32 = torch.randn(1, C, H, W, generator=gen, device=dev)
        disp = torch.rand(1, H, W, generator=gen, device=dev) * D
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[-1]
            ref, tar = feat32.to(dt), tar32.to(dt)
            # -- moments
            got = spamat.moments(ref, tar, rm, tm, D)
            want = spamat.moments_plain(ref, tar, rm, tm, D)
            torch.cuda.synchronize()
            act = rm != 0
            abs_err = rel_err = 0.0
            for g, w in zip(got, want):
                g, w = g[act], w[act]
                if not torch.isfinite(g).all():
                    fail(f"moments C={C} {dname}: non-finite output")
                d = (g - w).abs()
                abs_err = max(abs_err, float(d.max()))
                rel_err = max(rel_err, float((d / (w.abs() + 1e-30)).max()))
                if bool((d > MOMENTS_ATOL + MOMENTS_RTOL * w.abs()).any()):
                    fail(f"moments C={C} H={H} W={W} D={D} {dname}: "
                         f"max abs err {float(d.max()):.3e} past tolerance")
            r = {"shape": [C, H, W, D], "dtype": dname,
                 "max_abs_err": abs_err, "max_rel_err": rel_err}
            if dt == torch.bfloat16:
                pairs = candidate_pairs(torch, rm, tm, D)
                nbytes = (2 * ref.numel() * ref.element_size()
                          + 2 * rm.numel() * 4 + 4 * rm.numel() * 4)
                flops = pairs * (2 * C + 8)
                r.update(
                    ms=time_cuda(torch, lambda: spamat.moments(
                        ref, tar, rm, tm, D), 20, flush_buf),
                    plain_ms=time_cuda(torch, lambda: spamat.moments_plain(
                        ref, tar, rm, tm, D), 3, flush_buf),
                    bytes=nbytes, flops=flops,
                    bound_ms=max(nbytes / PEAK_BYTES, flops / PEAK_F32) * 1e3,
                    bound_by="bytes" if nbytes / PEAK_BYTES
                    >= flops / PEAK_F32 else "operations",
                    library_ms=None)
            rec["spamat_moments"].append(r)
            print(f"  moments C={C} {H}x{W} D={D} {dname}: "
                  + " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in r.items()
                             if k not in ("shape", "dtype")), flush=True)
            # -- warp
            got = kwarp.warp(ref, disp, D)
            want = kwarp.warp_plain(ref, disp, D)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            rtol, atol = WARP_TOL[dname]
            if not torch.isfinite(got.float()).all() or bool(
                    (d > atol + rtol * want.float().abs()).any()):
                fail(f"warp C={C} {H}x{W} {dname}: max abs err "
                     f"{float(d.max()):.3e} past tolerance")
            r = {"shape": [C, H, W, D], "dtype": dname,
                 "max_abs_err": float(d.max())}
            if dt == torch.bfloat16:
                # the library yardstick: grid_sample over the same warp
                # (x = (w - d) W/(W-1) - 0.5 is gx = 2 (w - d)/(W-1) - 1)
                gx = 2.0 * (torch.arange(W, device=dev) - disp) / (W - 1) - 1
                gy = (2.0 * torch.arange(H, device=dev) / (H - 1) - 1)
                grid = torch.stack([gx, gy.view(1, H, 1).expand_as(gx)], -1)
                grid = grid.to(dt)
                nbytes = 2 * ref.numel() * ref.element_size() + disp.numel() * 4
                flops = ref.numel() * 30.0
                r.update(
                    ms=time_cuda(torch, lambda: kwarp.warp(ref, disp, D), 20,
                                 flush_buf),
                    plain_ms=time_cuda(torch, lambda: kwarp.warp_plain(
                        ref, disp, D), 5, flush_buf),
                    bytes=nbytes, flops=flops,
                    bound_ms=max(nbytes / PEAK_BYTES, flops / PEAK_F32) * 1e3,
                    bound_by="bytes" if nbytes / PEAK_BYTES
                    >= flops / PEAK_F32 else "operations",
                    library_ms=time_cuda(torch, lambda: F.grid_sample(
                        ref, grid, align_corners=False), 20, flush_buf))
            rec["warp"].append(r)
            print(f"  warp C={C} {H}x{W} D={D} {dname}: "
                  + " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in r.items()
                             if k not in ("shape", "dtype")), flush=True)
    return rec


def kernel_parity_extra(torch, spamat, kwarp, gen):
    """The modes the served path does not reach, held against the plain
    versions too: a batch of two, and the windowed moments (|d - center|
    <= window), at the stage-2 shape in f32."""
    B, (C, H, W, D), window = 2, STAGES[1], 6
    rm = (torch.rand(B, H, W, generator=gen, device=DEV) < 0.5).float()
    tm = (torch.rand(B, H, W, generator=gen, device=DEV) < 0.5).float()
    ref = torch.randn(B, C, H, W, generator=gen, device=DEV)
    tar = torch.randn(B, C, H, W, generator=gen, device=DEV)
    center = torch.rand(B, H, W, generator=gen, device=DEV) * D
    errs = {}
    for name, kw in (("moments_b2", {}),
                     ("moments_b2_window", dict(center=center,
                                                window=window))):
        got = spamat.moments(ref, tar, rm, tm, D, **kw)
        want = spamat.moments_plain(ref, tar, rm, tm, D, **kw)
        act = rm != 0
        err = 0.0
        for g, w in zip(got, want):
            d = (g[act] - w[act]).abs()
            err = max(err, float(d.max()))
            if bool((d > MOMENTS_ATOL + MOMENTS_RTOL * w[act].abs()).any()):
                fail(f"{name}: max abs err {float(d.max()):.3e} past "
                     f"tolerance")
        errs[name] = err
    disp = torch.rand(B, H, W, generator=gen, device=DEV) * D
    d = (kwarp.warp(ref, disp, D) - kwarp.warp_plain(ref, disp, D)).abs()
    if float(d.max()) > WARP_TOL["float32"][1]:
        fail(f"warp_b2: max abs err {float(d.max()):.3e} past tolerance")
    errs["warp_b2"] = float(d.max())
    return errs


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="", help="also write the records here")
    args = p.parse_args()
    t_all = time.perf_counter()

    # -- 1. environment
    t0 = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a card")
    if not (os.path.isdir(os.path.join(ROOT, "decnet_tpu_torch"))
            and os.path.isfile(os.path.join(CKPT, "params.npz"))):
        fail(f"{ROOT} does not hold the port and its checkpoint")
    sys.path.insert(0, ROOT)
    from decnet_tpu_torch.cli.demo import predict
    from decnet_tpu_torch.data.synthetic import synthetic_pair
    from decnet_tpu_torch.ops.detail import detail_masks
    from decnet_tpu_torch.ops.kernels import build
    from decnet_tpu_torch.ops.kernels import spamat
    from decnet_tpu_torch.ops.kernels import warp as kwarp
    from decnet_tpu_torch.weights import load_checkpoint

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    print(card, flush=True)
    phase("environment", t0, torch=torch.__version__,
          cuda=torch.version.cuda, device=json.dumps(kind), count=count)

    # -- 2. build
    t0 = time.perf_counter()
    results = build.build(["spamat_moments", "warp"])
    for r in results:
        for line in r.ptxas.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                print(f"  {r.name}: {line.strip()}", flush=True)
    phase("build", t0, **{f"{r.name}_s": f"{r.seconds:.2f}" for r in results})

    # -- 3. kernel parity and timing
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(args.seed)
    flush_buf = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=DEV)
    with torch.no_grad():
        parity = kernel_parity(torch, spamat, kwarp, gen, flush_buf)
        extra = kernel_parity_extra(torch, spamat, kwarp, gen)
    phase("kernel_parity", t0, shapes=len(STAGES), dtypes=2,
          **{k: f"{v:.3g}" for k, v in extra.items()})

    # -- 4. load
    t0 = time.perf_counter()
    model = load_checkpoint(CKPT, device=DEV)
    nparams = sum(t.numel() for t in model.state_dict().values())
    phase("load", t0, dtype=model.cfg.dtype, tensors=len(model.state_dict()),
          values=nparams)

    # -- 5. serve
    t0 = time.perf_counter()
    H, W, D = SERVE
    requests = [synthetic_pair(H, W, gen, DEV)
                for _ in range(REQUESTS + 1)]
    warm, requests = requests[0], requests[1:]
    # the plain-path comparison below recomputes the masks: they must repeat
    a, b = (detail_masks(requests[0][0], 3, 3) for _ in range(2))
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail("detail masks are not deterministic on this card")
    predict(model, warm[0], warm[1], D)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spamat.moments.launches = 0
    kwarp.warp.launches = 0
    preds, lat = [], []
    for left, right, _, _ in requests:
        t = time.perf_counter()
        preds.append(predict(model, left, right, D))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    launches = {"spamat_moments": spamat.moments.launches,
                "warp": kwarp.warp.launches}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for i, ms in enumerate(lat):
        print(f"  request {i}: {ms:.3f} ms", flush=True)
    want = 3 * REQUESTS
    for k, n in launches.items():
        if n != want:
            fail(f"{k} launched {n} times in {REQUESTS} requests, "
                 f"expected {want}")
    epes = []
    for pred, (_, _, gt, valid) in zip(preds, requests):
        if pred.shape != (1, H, W) or not torch.isfinite(pred).all():
            fail(f"prediction of shape {tuple(pred.shape)} not finite")
        lo, hi = float(pred.min()), float(pred.max())
        if lo < -16 or hi > D:
            fail(f"prediction range [{lo:.3f}, {hi:.3f}] outside [-16, {D}]")
        epes.append(float((pred - gt).abs()[valid].mean()))
    model.use_kernels = False
    deltas = []
    for pred, (left, right, _, _) in zip(preds, requests):
        plain = predict(model, left, right, D)
        deltas.append((plain - pred).abs().flatten())
    model.use_kernels = True
    delta = torch.cat(deltas)
    mean_delta = float(delta.mean())
    p999 = float(torch.quantile(delta.float(), 0.999))
    if spamat.moments.launches != want or kwarp.warp.launches != want:
        fail("the plain path launched a kernel")
    if not mean_delta <= SERVE_MEAN_TOL:
        fail(f"kernel vs plain path: mean |delta disp| {mean_delta:.4g} px "
             f"> {SERVE_MEAN_TOL}")
    phase("serve", t0, requests=REQUESTS, size=f"{H}x{W}", max_disp=D,
          latency_ms=",".join(f"{x:.3f}" for x in lat),
          peak_mem_mb=f"{peak_mb:.1f}", launches=json.dumps(launches),
          plain_mean_abs_delta_px=f"{mean_delta:.5g}",
          plain_p999_abs_delta_px=f"{p999:.5g}",
          epe_px=",".join(f"{e:.4f}" for e in epes))

    # -- 6. the kernels line
    sources = {"spamat_moments": ("decnet_tpu_torch/csrc/spamat_moments.cu",
                                  "decnet_tpu/ops/pallas/spamat.py:80"),
               "warp": ("decnet_tpu_torch/csrc/warp.cu",
                        "decnet_tpu/ops/pallas/warp.py:49")}
    kernels = []
    for name, recs in parity.items():
        timed = [r for r in recs if "ms" in r]
        lib = [r["library_ms"] for r in timed]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            # per request: the sum over the three fine-stage shapes, bf16
            "ms": sum(r["ms"] for r in timed),
            "kernel_ms": sum(r["ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            "bound_by": max(timed, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None if None in lib else sum(lib)})
    torch.cuda.synchronize()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kind": kind, "parity": parity,
                       "parity_extra": extra,
                       "latency_ms": lat, "peak_mem_mb": peak_mb,
                       "epe_px": epes, "plain_mean_abs_delta_px": mean_delta,
                       "plain_p999_abs_delta_px": p999, "kernels": kernels,
                       "wall_s": time.perf_counter() - t_all}, f, indent=1)
    print(f"[total] {time.perf_counter() - t_all:.2f}s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
