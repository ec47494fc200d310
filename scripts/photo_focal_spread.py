#!/usr/bin/env python3
"""The focal and k1 the incremental engine recovers on the JAX photo test's
operating point, over RANSAC draws, in the JAX engine and the port's.

    python3 scripts/photo_focal_spread.py --run DIR [--make] [--engine jax|port] [--seeds 8]

DIR holds a front end's outputs for tests/test_pipeline_photos.py's scene
(40 distorted 640x480 views with radial K3 (-0.25, 0.06, -0.005) at f =
450 px, written as camera JPEGs): cameraInit.sfm, features/, matches.npz,
as `chip_smoke.hard_photos` leaves them under `photos_hard/`. `--make`
first runs `chip_smoke.hard_photos("cpu", ...)` into DIR's parent (the
port's CPU front end, ~2 min). Then the engine named runs incrementalSfm
at its defaults on those files for seeds 0..N-1 (the JAX one on the CPU,
~70 s a seed; the port's with `device="cpu"`, ~30 s) and prints one JSON
line a seed: posed views, the ATE over the ring's radius, (fx, fy), the
mean focal's error against 450 px (the JAX test's gate: 3 %) and k1 (its
gate: -0.40 to -0.12).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", required=True, help="a folder with cameraInit.sfm, features/, matches.npz")
    ap.add_argument("--make", action="store_true", help="run the port's CPU front end into --run first")
    ap.add_argument("--engine", choices=("jax", "port"), default="port")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    import torch

    torch.set_num_threads(args.threads)
    import chip_smoke
    from alicevision_tpu_torch.utils.rendered import hard_scene

    cfg = chip_smoke.PHOTO_HARD
    if args.make:
        work = os.path.dirname(os.path.abspath(args.run.rstrip("/")))
        print(json.dumps(chip_smoke.hard_photos("cpu", work, cfg)), flush=True)
    c_gt = hard_scene(cfg["n_views"], 600).c
    p = lambda *x: os.path.join(args.run, *x)  # noqa: E731
    if args.engine == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from alicevision_tpu.pipeline import stages as jstages

        def run(seed, out):
            return jstages.incremental_sfm(p("cameraInit.sfm"), p("features"), p("matches.npz"), out, seed=seed)
    else:
        from alicevision_tpu_torch.pipeline import stages

        def run(seed, out):
            return stages.incremental_sfm(p("cameraInit.sfm"), p("features"), p("matches.npz"), out, seed=seed,
                                          device="cpu")

    with tempfile.TemporaryDirectory() as tmp:
        for seed in range(args.seeds):
            sc = run(seed, os.path.join(tmp, f"sfm_{seed}.sfm"))
            vp = np.asarray(sc.view_pose)
            posed = np.nonzero(vp >= 0)[0]
            ate, _ = chip_smoke._ate_rel(np.asarray(sc.pose_c)[vp[posed]], c_gt[posed], c_gt)
            f = np.asarray(sc.scale, np.float64)[0]
            print(json.dumps({"engine": args.engine, "seed": seed, "posed": int(len(posed)), "ate_frac_of_radius": ate,
                              "focal_px": f.tolist(), "focal_err": float(abs(f.mean() - cfg["focal_px"]) / cfg["focal_px"]),
                              "k1": float(np.asarray(sc.disto)[0][0])}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
