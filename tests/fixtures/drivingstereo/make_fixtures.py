"""Writes the DrivingStereo fixture tree beside this script: three scenes
at DrivingStereo's 400x881 under test/{left-image,right-image,
disparity-map}/, and manifest.json.

The views come from the port's host synthetic stream
(decnet_tpu_torch/data/synthetic.py::make_pair, seeds 0-2, disparities up
to 96 px), written as baseline JPEG (quality 90, 4:2:0, optimised Huffman tables)
by cv2; the disparities as uint16 PNGs of disparity x 256.  The manifest records, per JPEG, the
SHA-256 of cv2's RGB decode (cv2.imread(IMREAD_COLOR), BGR->RGB), and the
JAX package's `cli.eval` on the tree with runs/ckpt_faithful in bfloat16
on the CPU: its mean EPE, its per-scene EPEs and the command.

Needs cv2 and JAX, so it runs where those are installed; nothing in the
packages imports it.  Run from the root of the repository:

    python tests/fixtures/drivingstereo/make_fixtures.py
"""
import hashlib
import json
import os
import re
import subprocess
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)

from decnet_tpu_torch.data.synthetic import make_pair  # noqa: E402

H, W, MAX_DISP, SCENES = 400, 881, 96, 3
JPEG = [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_OPTIMIZE, 1,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
EVAL = [sys.executable, "-m", "decnet_tpu.cli.eval", "--dataset",
        "drivingstereo", "--root", "tests/fixtures/drivingstereo",
        "--test_split", "test", "--batch_size", "1", "--num_workers", "1",
        "--resume", "runs/ckpt_faithful", "--save2where",
        "build/drivingstereo_fixture_eval"]


def rgb_sha256(path: str) -> str:
    img = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def main():
    base = os.path.join(HERE, "test")
    dirs = {d: os.path.join(base, d)
            for d in ("left-image", "right-image", "disparity-map")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    images = {}
    for i in range(SCENES):
        d = make_pair(np.random.RandomState(i), H, W, MAX_DISP)
        name = f"scene_{i:03d}"
        for view, key in (("left-image", "left"), ("right-image", "right")):
            path = os.path.join(dirs[view], name + ".jpg")
            bgr = np.clip(np.round(d[key]), 0, 255).astype(np.uint8)[..., ::-1]
            cv2.imwrite(path, bgr, JPEG)
            images[f"{view}/{name}.jpg"] = rgb_sha256(path)
        cv2.imwrite(os.path.join(dirs["disparity-map"], name + ".png"),
                    np.round(d["gt"] * 256).astype(np.uint16),
                    [cv2.IMWRITE_PNG_COMPRESSION, 9])
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    log = subprocess.run(EVAL, cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True).stdout
    epes = [float(x) for x in re.findall(r"batch \d+: EPE ([0-9.]+)", log)]
    mean = float(re.search(r"MEAN EPE: ([0-9.]+)", log).group(1))
    manifest = {
        "size": [H, W], "scenes": SCENES, "jpeg_quality": 90,
        "sampling": "4:2:0", "rgb_sha256": images,
        "jax_eval": {"command": " ".join(["python"] + EVAL[1:]),
                     "dtype": "bfloat16", "device": "cpu",
                     "epe_per_scene": epes, "mean_epe": mean}}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    print(json.dumps(manifest["jax_eval"]))


if __name__ == "__main__":
    main()
