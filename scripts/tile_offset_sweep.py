#!/usr/bin/env python3
"""How far the rectified sweep of a tile goes wrong as the tile's principal
point moves off its centre, and as the crop narrows: the measurement
behind sending every tile of a tiled depth map to the gather sweep
(`mvs/sharded.py::sgm_depth_map_tiled`).

    python3 scripts/tile_offset_sweep.py [--device cpu] [--views 1,4,8] [--threads 4]

from the repository root (the port only; on the CPU about 20 minutes with
4 threads). On chip_smoke.make_posed_scene's 8 views at D = 96 (the
dense_full phase's scene, maps at 640x480) it crops view v's reference at
a series of positions, so that the crop's principal point lies a known
distance from the crop's centre, and runs one SGM map of the crop by the
rectified sweep and one by the gather sweep, with the view's own seeded
depth list and its 4 T-cams at full size. For each crop it prints one JSON
line: the principal point's offset from the crop's centre in pixels and as
a fraction of the crop's size (the larger of the two axes), both maps'
median relative depth error against the rendered depth
(chip_smoke.depth_stats), and the median distance of the rectified map
from the gather map in depth steps of the plane list, on the pixels where
the rendered scene has a surface.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from alicevision_tpu_torch.device import resolve_device  # noqa: E402
from alicevision_tpu_torch.mvs import plane_sweep as ps  # noqa: E402
from alicevision_tpu_torch.pipeline import stages  # noqa: E402

N_DEPTHS = 96
# (crop size, [(x0, y0), ...]): 384-px crops (the dense_full tiles) moved
# along x and along y across the 640x480 map, and 256-px crops along x
CROPS = [
    (384, [(x0, 48) for x0 in (0, 32, 64, 96, 112, 120, 128, 136, 144, 160, 192, 224, 256)]
     + [(128, y0) for y0 in (0, 24, 72, 96)]),
    (256, [(x0, 112) for x0 in (192, 176, 160, 128, 96, 64)]),
]


def steps_apart(a: np.ndarray, b: np.ndarray, gt: np.ndarray, depths: np.ndarray) -> float:
    """Median |a - b| in local steps of the inverse-depth plane list, where
    the scene has a surface and both maps are valid."""
    valid = (a > 0) & (b > 0) & (gt > 0)
    inv = 1.0 / np.asarray(depths, np.float64)
    step = b[valid] ** 2 * (abs(inv[0] - inv[-1]) / (len(inv) - 1))
    return float(np.median(np.abs(a[valid] - b[valid]) / step))


def sweep_view(sfm, dense, gt, v, dev):
    args, kw = chip_smoke._view_inputs(sfm, dense, v, N_DEPTHS, dev)
    ref, timgs, K, Kt, R, t, _, _ = args
    g = gt[v, ::2, ::2]
    depths = np.asarray(kw["depths"], np.float32)
    for size, corners in CROPS:
        for x0, y0 in corners:
            y1, x1 = y0 + size, x0 + size
            Kc = K.clone()
            Kc[0, 2] -= x0
            Kc[1, 2] -= y0
            off = [float(Kc[0, 2]) - size / 2.0, float(Kc[1, 2]) - size / 2.0]
            row = {"view": v + 1, "crop": [y0, y1, x0, x1], "pp_offset_px": off,
                   "pp_offset_frac": max(abs(o) for o in off) / size}
            maps = {}
            for method in ("rectified", "gather"):
                d, _ = ps.sgm_depth_map(
                    ref[y0:y1, x0:x1].contiguous(), timgs, Kc, Kt, R, t, 1.0, 2.0,
                    ps.SgmParams(n_depths=N_DEPTHS, method=method), depths=kw["depths"],
                    tc_depth_ranges=kw["tc_depth_ranges"],
                )
                maps[method] = d.cpu().numpy()
                row[method + "_median_rel_err"] = chip_smoke.depth_stats(maps[method], g[y0:y1, x0:x1])[0]
            row["rectified_vs_gather_median_steps"] = steps_apart(
                maps["rectified"], maps["gather"], g[y0:y1, x0:x1], depths)
            print("tile_offset " + json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--views", default="1,4,8", help="1-based views of the scene")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    dev = resolve_device(args.device)
    work = tempfile.mkdtemp(prefix=".chip_smoke_offset_", dir=ROOT)
    try:
        sfm, gt = chip_smoke.make_posed_scene(work)
        dense = os.path.join(work, "dense")
        stages.prepare_dense_scene(sfm, dense, device=dev)
        for v in args.views.split(","):
            sweep_view(sfm, dense, gt, int(v) - 1, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
