"""This checkout's kernels against another checkout's, on one card, in one
call: `chip_smoke.py` of each in turns (other, this, this, other), then
`python -m decnet_tpu_torch.cli.phase_split` of each, and a summary of
the kernels' times per stage shape.

The other checkout is usually the parent commit, unpacked with
`git archive` into a directory that .gitignore lists (its checkpoint may
be a symlink to this one's).

Usage:  python -m decnet_tpu_torch.cli.ab_kernels --other DIR --out DIR
Needs one CUDA card.  Writes `<out>/<run>.json` and `<out>/<run>.log` for
each run and prints the summary.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
RUNS = (("other", "smoke"), ("this", "smoke"), ("this", "smoke"),
        ("other", "smoke"), ("other", "split"), ("this", "split"))
RUN_TIMEOUT = 600  # seconds a run may take


def per_stage(recs):
    return [r["ms"] for r in recs if "ms" in r]


def summary(d):
    """One record's kernel times per stage shape (ms) and its checks."""
    out = {}
    for path, key in (("serve", "parity"), ("train", "parity_train")):
        for name, recs in d[key].items():
            out[f"{name} {path}"] = per_stage(recs)
            if name == "warp":
                out[f"grid_sample {path}"] = [r["library_ms"] for r in recs
                                              if "ms" in r]
                out[f"copy {path}"] = [r.get("copy_ms") for r in recs
                                       if "ms" in r]
    for name, recs in d["backward"].items():
        out[f"{name} train"] = per_stage(recs)
    for key in ("timing_floor_ms", "timing_floor_no_flush_ms"):
        out[key] = d.get(key)
    out["checks"] = {
        "serve_ms": d["latency_ms"], "step_ms": d["train"]["step_ms"],
        "plain_mean_abs_delta_px": d["plain_mean_abs_delta_px"],
        "train_loss_rel": d["train"]["plain_loss_rel"],
        "train_grad_cos": d["train"]["plain_grad_cos"],
        "faults_grad_cos": {k: v["grad_cos"] for k, v in
                            d["train"]["planted_faults"].items()},
        "max_rel_err": {k: max(r["rel_err"] for r in v)
                        for k, v in d["backward"].items()}}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--other", required=True, help="the other checkout")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    other = Path(args.other).resolve()
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    tree = {"this": ROOT, "other": other}
    records, rcs = {}, {}
    for i, (who, what) in enumerate(RUNS):
        name = f"{i}_{who}_{what}"
        if what == "smoke":
            cmd = [sys.executable, "chip_smoke.py", "--out",
                   str(out / f"{name}.json")]
        else:
            cmd = [sys.executable, "-m", "decnet_tpu_torch.cli.phase_split",
                   "--out", str(out / f"{name}.json")]
        with open(out / f"{name}.log", "w") as log:
            try:
                rc = subprocess.run(cmd, cwd=tree[who], stdout=log,
                                    stderr=subprocess.STDOUT,
                                    timeout=RUN_TIMEOUT,
                                    env={**os.environ,
                                         "PYTHONPATH": str(tree[who])}
                                    ).returncode
            except subprocess.TimeoutExpired:
                rc = 124
        rcs[name] = rc
        print(f"{name}: rc {rc}", flush=True)
        if rc == 0:
            records[name] = json.loads((out / f"{name}.json").read_text())
    for name, d in records.items():
        if name.endswith("smoke"):
            print(name, json.dumps(summary(d)), flush=True)
        else:
            for r in d["records"]:
                print(f"{name} {r['kernel']} {r['path']} {r['shape']}: "
                      f"blocks {r['blocks']} ({r['blocks_full']} full), "
                      f"{r['block_us']:.2f} us = " + " + ".join(
                          f"{n} {u:.2f}" for n, u in zip(r["phases"],
                                                        r["phase_us"])),
                      flush=True)
    for name in records:
        if name.endswith("smoke"):
            log = (out / f"{name}.log").read_text().splitlines()
            for line in log:
                if "registers" in line or "spill" in line:
                    print(name, line.strip(), flush=True)
    sys.exit(0 if all(rc == 0 for rc in rcs.values()) else 1)


if __name__ == "__main__":
    main()
