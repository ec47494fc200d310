#!/usr/bin/env python3
"""Repeat the `photos` phase's JAX-photo-test run on one card and say
which stage varies from run to run.

    python3 scripts/photo_repeat_torch.py [--runs 5] [--engine-runs 3] [--out chiprun_out]

Runs `chip_smoke.hard_photos` (40 distorted 640x480 views rendered on the
card, camera JPEGs, cameraInit from EXIF -> DSP-SIFT at 4096 -> voctree
pairs -> featureMatching -> incrementalSfm) `--runs` times in one process,
each into its own folder, and prints a JSON line a run: the gates' numbers
(posed, ATE, focal and its error against 450 px, k1) and a SHA-256 of each
stage's output (the rendered JPEGs, the features, pairs.txt, the matches).
Then it runs incrementalSfm `--engine-runs` times more on the first run's
files (the engine alone, fed fixed inputs). With `--out`, the lines also
go to OUT/photo_repeat.jsonl. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from alicevision_tpu_torch.pipeline import stages  # noqa: E402
from alicevision_tpu_torch.utils.rendered import hard_scene  # noqa: E402


def tree_sha(path: str) -> str:
    """SHA-256 over a file, or over a folder's files in name order."""
    h = hashlib.sha256()
    files = [path] if os.path.isfile(path) else [os.path.join(path, f) for f in sorted(os.listdir(path))]
    for name in files:
        with open(name, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--engine-runs", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("photo_repeat_torch.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    cfg = chip_smoke.PHOTO_HARD
    c_gt = hard_scene(cfg["n_views"], 600).c
    lines = []

    def emit(row):
        lines.append(row)
        print(json.dumps(row), flush=True)

    work = tempfile.mkdtemp(prefix=".photo_repeat_", dir=chip_smoke.ROOT)
    try:
        for k in range(args.runs):
            run = os.path.join(work, f"run{k}")
            row = chip_smoke.hard_photos(dev, run, cfg)
            p = lambda *x: os.path.join(run, "photos_hard", *x)  # noqa: E731
            row["focal_err"] = abs(float(np.mean(row["focal_px"])) - cfg["focal_px"]) / cfg["focal_px"]
            row["sha"] = {name: tree_sha(p(name)) for name in ("images", "features", "pairs.txt", "matches.npz")}
            emit({"run": k, "device": smi, **row})
        first = lambda *x: os.path.join(work, "run0", "photos_hard", *x)  # noqa: E731
        for k in range(args.engine_runs):
            sc = stages.incremental_sfm(first("cameraInit.sfm"), first("features"), first("matches.npz"),
                                        os.path.join(work, f"engine{k}.sfm"), device=dev)
            posed = sc.valid_views()
            ate, _ = chip_smoke._ate_rel(sc.pose_c[sc.view_pose[posed]], c_gt[posed], c_gt)
            f = sc.scale[0].astype(np.float64)
            emit({"engine_run": k, "posed": int(len(posed)), "ate_frac_of_radius": ate, "focal_px": f.tolist(),
                  "focal_err": abs(float(f.mean()) - cfg["focal_px"]) / cfg["focal_px"], "k1": float(sc.disto[0][0])})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "photo_repeat.jsonl"), "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in lines)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
