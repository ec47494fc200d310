#!/usr/bin/env python3
"""chip_smoke.py's `localization` phase alone on the card, without its
gates: the numbers to set them against, and the inputs the JAX reference
needs to read the same scene.

    python3 scripts/localization_phase_torch.py [--out DIR] [--databases N] [--seeds K] [--runs A,B]

from the repository root, on a machine with a CUDA card. It runs the
hard_scene phase's images path (`chip_smoke.run_hard_images`: 40 distorted
1280x960 views, DSP-SIFT at 10,000 keypoints, voctree pairs, matching,
incrementalSfm), then `chip_smoke.run_localization_phase` on its
reconstruction, and prints the card's name and power limit, the gates it
misses (`chip_smoke.localization_misses`, printed, not raised) and the
`localization` row as one JSON line. With `--out`, DIR/localization_phase.json
holds the row and DIR/localization_inputs/ the reconstruction with its
feature ids (`database.sfm`) and, per view, only the features its
observations name (renumbered; ~13 MB), which
`scripts/localization_reference.py --inputs DIR/localization_inputs` reads.

With --seeds K, each cameraLocalization run of the phase is repeated with
the CLI's loop for draws k = 0..K-1 (`chip_smoke.localization_sweep`: the
vocabulary tree trained with seed k, the RANSAC generator seeded k; draw 0
is the CLI's; --runs picks the runs, all by default),
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

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from alicevision_tpu_torch.utils.rendered import _ring_cameras  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--databases", type=int, default=1, help="reconstructions to sweep (the phase runs on the first)")
    ap.add_argument("--seeds", type=int, default=0, help="RANSAC seeds a cameraLocalization run in the sweep")
    ap.add_argument("--runs", default=",".join(chip_smoke.LOC_CAMERA_RUNS),
                    help="comma-separated camera runs of the sweep (default all)")
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
                sweep = chip_smoke.localization_sweep(os.path.join(loc, "database.sfm"), feats, inputs, R_gt, c_gt, dev,
                                                      args.seeds, runs=args.runs.split(","))
                print(f"seed_sweep {i} " + json.dumps(sweep), flush=True)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                if i == 0:
                    with open(os.path.join(args.out, "localization_phase.json"), "w") as f:
                        json.dump(row, f, indent=1)
                kept = chip_smoke.save_localization_inputs(os.path.join(loc, "database.sfm"), feats, os.path.join(
                    args.out, "localization_inputs" + (f"_{i}" if i else "")))
                print(f"saved inputs {i}: " + json.dumps(kept), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"localization": row}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
