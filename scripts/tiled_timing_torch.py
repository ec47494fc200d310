#!/usr/bin/env python3
"""The port's two tiled depth-map points on the card, timed and checked
against the untiled maps of the same views.

    python3 scripts/tiled_timing_torch.py [--root DIR] [--out DIR] [--label NAME]

from the root of this checkout. The measurement is this checkout's
chip_smoke.py (`make_posed_scene`, `tiled_seam_stats`,
`bench_tiled_point`); the port package timed is the one in --root (by
default this checkout), so a parent commit unpacked into a folder is
timed by the same code in the same call. It prints the card's nvidia-smi
name and power limit and two JSON lines:

1. `tiled_stage`: chip_smoke's dense_full scene (8 views of 1280x960,
   maps at 640x480, D = 96): depthMapEstimation untiled, then tiled
   (384-px tiles, 64 overlap), each timed warm (a second run into a fresh
   folder: the stage skips the views whose maps a folder holds);
   per view the tiled map's median relative error against the rendered
   depth beside the untiled map's, and its median distance from the
   untiled map in depth steps (chip_smoke.tiled_seam_stats);
2. `tiled_bench`: bench.py's tiled point (1920x1088, 1024-px tiles, 128
   overlap, D = 128), chip_smoke.bench_tiled_point: sgm_depth_map_tiled
   best of 3 warm calls as maps/s with the peak device memory, and its
   median relative error and median distance from the untiled map of the
   view.

With --out it also writes both lines to DIR/tiled_timing_<label>.json.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke(root: str):
    """This checkout's chip_smoke.py, with `root`'s alicevision_tpu_torch
    first on the path."""
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed_stage(stages, dev, sfm, dense, folder, **kw):
    """depthMapEstimation into `folder`_warm, then the wall seconds of a
    second run into `folder`."""
    for out in (folder + "_warm", folder):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stages.depth_map_estimation(sfm, dense, out, device=dev, **kw)
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def tiled_stage(chip_smoke, dev, work):
    from alicevision_tpu_torch.mvs.sharded import make_tiles

    stages = chip_smoke.stages
    sfm, gt = chip_smoke.make_posed_scene(work)
    dense = os.path.join(work, "dense")
    stages.prepare_dense_scene(sfm, dense, device=dev)
    full, tiled = os.path.join(work, "untiled"), os.path.join(work, "tiled")
    row = {"untiled_s": timed_stage(stages, dev, sfm, dense, full, n_depths=96),
           "tiled_s": timed_stage(stages, dev, sfm, dense, tiled, n_depths=96, tile_size=chip_smoke.TILE_SIZE,
                                  tile_overlap=chip_smoke.TILE_OVERLAP),
           "views": []}
    rois = make_tiles(480, 640, chip_smoke.TILE_SIZE, chip_smoke.TILE_OVERLAP, clamp=True)
    for v in range(gt.shape[0]):
        d_t = np.load(os.path.join(tiled, f"{v + 1}_depth.npy"))
        d_f = np.load(os.path.join(full, f"{v + 1}_depth.npy"))
        g = gt[v, ::2, ::2]
        row["views"].append({
            "tiled_median_rel_err": chip_smoke.depth_stats(d_t, g)[0],
            "untiled_median_rel_err": chip_smoke.depth_stats(d_f, g)[0],
            "median_steps_from_untiled": chip_smoke.tiled_seam_stats(d_t, d_f, g, 96, rois)["median_steps"],
        })
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--root", default=HERE, help="the checkout whose alicevision_tpu_torch is timed")
    ap.add_argument("--out", default=None)
    ap.add_argument("--label", default="run")
    args = ap.parse_args()
    chip_smoke = load_chip_smoke(args.root)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = tempfile.mkdtemp(prefix=".chip_smoke_tiled_", dir=HERE)
    try:
        rows = {"label": args.label, "card": smi, "tiled_stage": tiled_stage(chip_smoke, dev, work),
                "tiled_bench": chip_smoke.bench_tiled_point(dev)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for k in ("tiled_stage", "tiled_bench"):
        print(f"{k} {args.label} " + json.dumps(rows[k]), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"tiled_timing_{args.label}.json"), "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
