#!/usr/bin/env python3
"""chip_smoke.py's `localization` phase alone on the card, without its
gates: the numbers to set them against, and the inputs the JAX reference
needs to read the same scene.

    python3 scripts/localization_phase_torch.py [--out DIR] [--databases N] [--seeds K]

from the repository root, on a machine with a CUDA card. It runs the
hard_scene phase's images path (`chip_smoke.run_hard_images`: 40 distorted
1280x960 views, DSP-SIFT at 10,000 keypoints, voctree pairs, matching,
incrementalSfm), then `chip_smoke.run_localization_phase` on its
reconstruction, and prints the card's name and power limit, the gates it
misses (`chip_smoke.localization_misses`, printed, not raised) and the
`localization` row as one JSON line. With `--out`, DIR/localization_phase.json
holds the row and DIR/localization_inputs/ the reconstruction with its
feature ids (`database.sfm`) and, per view, only the features its
observations name (renumbered; ~20 MB), which
`scripts/localization_reference.py --inputs DIR/localization_inputs` reads.

With --seeds K, each cameraLocalization run of the phase is repeated with
the CLI's loop for draws k = 0..K-1 (`seed_sweep`: the vocabulary tree
trained with seed k, the RANSAC generator seeded k; draw 0 is the CLI's),
and the right and wrong successes of each draw are printed (`seed_sweep`
lines). With --databases N, the images path runs N
times (incrementalSfm on the card is not deterministic, so each run gives
its own reconstruction); the phase runs on the first, the sweep on each,
and DIR/localization_inputs_<i>/ holds reconstruction i > 0.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from alicevision_tpu_torch import sfmdata  # noqa: E402
from alicevision_tpu_torch.utils.rendered import _ring_cameras  # noqa: E402


def save_compact_inputs(db_sfm: str, feats: str, out: str) -> dict:
    """`db_sfm` and the features its observations name, renumbered per
    view, into `out` (database.sfm, features/<viewId>.feat.npz)."""
    sc = sfmdata.load(db_sfm)
    fdir = os.path.join(out, "features")
    os.makedirs(fdir, exist_ok=True)
    new_fid = np.zeros(sc.n_observations, np.int64)
    kept = 0
    for v in range(sc.n_views):
        vid = int(sc.view_ids[v])
        sel = np.nonzero(sc.obs_view == v)[0]
        with np.load(os.path.join(feats, f"{vid}.feat.npz")) as z:
            f = {k: z[k] for k in z.files}
        used, inv = np.unique(sc.obs_feature[sel], return_inverse=True)
        new_fid[sel] = inv
        kept += len(used)
        np.savez_compressed(os.path.join(fdir, f"{vid}.feat.npz"), **{k: a[used] for k, a in f.items()})
    sc.obs_feature = new_fid
    sfmdata.save(sc, os.path.join(out, "database.sfm"))
    return {"views": int(sc.n_views), "observations": int(sc.n_observations), "features_kept": int(kept)}


def seed_sweep(db_sfm: str, feats: str, inputs: dict, R_gt, c_gt, dev, seeds: int) -> dict:
    """The phase's cameraLocalization runs (`chip_smoke.
    localization_camera_runs`) as the port's CLI loops over the queries,
    for draws k < seeds: the tree of VoctreeLocalizer(seed=k), the RANSAC
    generator seeded k. Returns {run: [chip_smoke.sweep_entry of each
    draw]}."""
    from alicevision_tpu_torch.localization import localize_image
    from alicevision_tpu_torch.localization.voctree_localizer import VoctreeLocalizer
    from alicevision_tpu_torch.pipeline import cli_ext

    sc = sfmdata.load(db_sfm)
    align, C = chip_smoke._database_frame(sc, R_gt, c_gt)
    radius = float(np.linalg.norm(c_gt - c_gt.mean(0), axis=1).mean())
    obs_desc = cli_ext._obs_descriptors(sc, feats)
    vlocs = {}
    lm_desc, lm_pts = cli_ext._build_landmark_index_from_features(sc, feats)
    row = sc.intrinsics_table(device=dev).row(0)
    fx, wh = float(np.mean(sc.scale[:, 0])), (float(sc.sizes[0, 0]), float(sc.sizes[0, 1]))
    poses = inputs["poses"]
    out = {}
    for run, (method, folder, ds) in chip_smoke.localization_camera_runs(inputs).items():
        names = cli_ext._list_queries(folder)
        qf = [cli_ext._query_features(os.path.join(folder, n), row, dev, 2048, 1024 if ds is None else ds)
              for n in names]
        out[run] = []
        for seed in range(seeds):
            gen = torch.Generator(device=dev).manual_seed(seed)
            res = {}
            if method == "voctree" and seed not in vlocs:
                vlocs[seed] = VoctreeLocalizer(sc.points, sc.obs_landmark, sc.obs_view, obs_desc, seed=seed,
                                               device=dev)
            for n, (desc, p) in zip(names, qf):
                r = (vlocs[seed].localize(gen, desc, p, fx, wh) if method == "voctree"
                     else localize_image(gen, lm_desc, lm_pts, desc, p, fx, wh, device=dev))
                res[n] = {"success": bool(r.success), "n_inliers": int(r.n_inliers), "R": np.asarray(r.R).tolist(),
                          "c": np.asarray(r.c).tolist()}
            out[run].append(chip_smoke.sweep_entry(res, names, poses["R0"], poses["c0"], align, C, radius, seed))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--databases", type=int, default=1, help="reconstructions to sweep (the phase runs on the first)")
    ap.add_argument("--seeds", type=int, default=0, help="RANSAC seeds a cameraLocalization run in the sweep")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    work = tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT)
    _, R_gt, c_gt = _ring_cameras(chip_smoke.HARD_VIEWS, 6.0, 1.2, chip_smoke.HARD_IMG["focal_px"],
                                  chip_smoke.HARD_IMG["wh"], 0)
    try:
        for i in range(args.databases):
            db_work = work if i == 0 else os.path.join(work, f"db{i}")
            os.makedirs(db_work, exist_ok=True)
            seconds, _, out, _ = chip_smoke.run_hard_images(db_work, dev)
            print(f"hard images path {i}: " + json.dumps({"stage_seconds": seconds,
                                                          "posed": int((out.view_pose >= 0).sum())}), flush=True)
            feats = os.path.join(db_work, "hard_features")
            loc = os.path.join(db_work, "localization")
            if i == 0:
                row = chip_smoke.run_localization_phase(dev, work, os.path.join(work, "hard_sfm.sfm"), feats, R_gt,
                                                        c_gt, smi=smi)
                print("misses at the gates: " + json.dumps(chip_smoke.localization_misses(row)), flush=True)
                inputs = chip_smoke.make_localization_inputs(os.path.join(work, "sweep_queries"), dev)
            else:
                os.makedirs(loc, exist_ok=True)
                chip_smoke.with_feature_ids(os.path.join(db_work, "hard_sfm.sfm"), feats,
                                            os.path.join(loc, "database.sfm"))
            if args.seeds:
                sweep = seed_sweep(os.path.join(loc, "database.sfm"), feats, inputs, R_gt, c_gt, dev, args.seeds)
                print(f"seed_sweep {i} " + json.dumps(sweep), flush=True)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                if i == 0:
                    with open(os.path.join(args.out, "localization_phase.json"), "w") as f:
                        json.dump(row, f, indent=1)
                kept = save_compact_inputs(os.path.join(loc, "database.sfm"), feats, os.path.join(
                    args.out, "localization_inputs" + (f"_{i}" if i else "")))
                print(f"saved inputs {i}: " + json.dumps(kept), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"localization": row}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
