#!/usr/bin/env python3
"""Why the cli phase's chain misses the pipeline phase's rotation gate.

    python3 scripts/cli_chain_diagnostics_torch.py --out OUT [--repeats 6]

from the repository root, on the card (the port only). On
chip_smoke.make_posed_scene's 8 views (1280x960, focal 1120 px) it runs the
front of `chip_smoke.cli_chain` (cameraInit, featureExtraction,
imageMatching, featureMatching) as `python -m
alicevision_tpu_torch.pipeline.cli` processes, once with the CLI's default
DSP-SIFT and once with plain SIFT (`--describerTypes sift`, the runner's
describer), each process timed with its sampled host peak
(`chip_smoke.run_cli_process`). Then it prints, as JSON lines:

1. `keypoints`: every view's DSP-SIFT features extracted again on the CPU
   (`featureExtraction --device cpu`) against the card's: valid keypoints
   of each, the share of the CPU's with a card keypoint within 0.05 px, and
   the median and largest distance to the nearest card keypoint;
2. `engine`: incrementalSfm `--repeats` times in this process on each
   feature set on the card: posed views, camera-centre ATE (fraction of the
   ring radius), the largest rotation error after the orientations'
   alignment (`chip_smoke.rotation_errors_deg`), and the refined focal.

The card's DSP-SIFT cameraInit.sfm, features, pairs and matches are copied
to `<out>/cli_chain_features/`, with the card's name and power limit, for
`scripts/cli_chain_reference.py` (the JAX package and the port on the CPU
on those same features).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from alicevision_tpu_torch import sfmdata  # noqa: E402
from alicevision_tpu_torch.pipeline import cli  # noqa: E402
from alicevision_tpu_torch.pipeline.stages import load_features  # noqa: E402

FRONT = ("cameraInit", "featureExtraction", "imageMatching", "featureMatching")
SAME_PX = 0.05


def run_front(work: str, image_folder: str, describer: str, dev: str) -> dict:
    """The front of the cli chain as processes; their seconds and peaks."""
    logs = os.path.join(work, "logs")
    os.makedirs(logs, exist_ok=True)
    rows = {}
    for name, argv in chip_smoke.cli_chain(work, image_folder, extra=["--device", dev]):
        if name not in FRONT:
            continue
        if name == "featureExtraction":
            argv = argv + ["--describerTypes", describer]
        res = chip_smoke.run_cli_process(argv, os.path.join(logs, name))
        if res["rc"] != 0:
            raise RuntimeError(f"`{' '.join(argv)}` exited {res['rc']}: {res['stderr'][-2000:]}")
        rows[name] = {k: res[k] for k in ("seconds", "stage_s", "host_peak_gib", "device_peak_gib")}
    return rows


def compare_keypoints(card_folder: str, cpu_folder: str, view_ids) -> list:
    from scipy.spatial import cKDTree

    out = []
    for v in view_ids:
        a, b = load_features(cpu_folder, v), load_features(card_folder, v)
        xa, xb = a["xy"][a["valid"]].astype(np.float64), b["xy"][b["valid"]].astype(np.float64)
        dist, _ = cKDTree(xb).query(xa)
        out.append({"view": int(v), "keypoints_cpu": int(len(xa)), "keypoints_card": int(len(xb)),
                    "frac_within_0.05px": float((dist < SAME_PX).mean()),
                    "median_px": float(np.median(dist)), "max_px": float(dist.max())})
    return out


def engine_runs(work: str, R_true, c_true, repeats: int, dev: str) -> list:
    init = os.path.join(work, "cameraInit.sfm")
    runs = []
    for r in range(repeats):
        out = os.path.join(work, f"sfm_{r}.sfm")
        rc = cli.main(["incrementalSfm", "--input", init, "--features", os.path.join(work, "features"),
                       "--matches", os.path.join(work, "matches.npz"), "--output", out, "--device", dev])
        if rc != 0:
            raise RuntimeError(f"incrementalSfm run {r} exited {rc}")
        sc = sfmdata.load(out)
        posed = sc.valid_views()
        rot, _ = chip_smoke.rotation_errors_deg(sc.pose_R[sc.view_pose[posed]], R_true[posed])
        ate = chip_smoke._posed_ate(out, R_true, c_true)
        runs.append({"n_posed": ate["n_posed"], "landmarks": ate["landmarks"],
                     "ate_frac_of_radius": ate["ate_frac_of_radius"], "max_rotation_err_deg": max(rot),
                     "focal_px": sc.scale.tolist()})
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="folder for the saved features")
    ap.add_argument("--repeats", type=int, default=6, help="incrementalSfm runs on each feature set")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = "cuda:0"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    work = tempfile.mkdtemp(prefix="cli_chain_diag_")
    try:
        sfm, _ = chip_smoke.make_posed_scene(work, n_views=8)
        truth = sfmdata.load(sfm)
        R_true, c_true = truth.pose_R[truth.view_pose], truth.pose_c[truth.view_pose]
        images = os.path.join(work, "images")
        sets = {}
        for describer in ("dspsift", "sift"):
            w = os.path.join(work, describer)
            sets[describer] = w
            print(json.dumps({"front": describer, "device": smi,
                              "processes": run_front(w, images, describer, dev)}), flush=True)

        dsp = sets["dspsift"]
        init = os.path.join(dsp, "cameraInit.sfm")
        cpu_feats = os.path.join(work, "dspsift_cpu_features")
        if cli.main(["featureExtraction", "--input", init, "--output", cpu_feats, "--device", "cpu"]) != 0:
            raise RuntimeError("featureExtraction on the CPU failed")
        view_ids = [int(v) for v in sfmdata.load(init).view_ids]
        print(json.dumps({"keypoints": compare_keypoints(os.path.join(dsp, "features"), cpu_feats, view_ids),
                          "device": smi}), flush=True)

        for describer, w in sets.items():
            print(json.dumps({"engine": describer, "device": smi,
                              "runs": engine_runs(w, R_true, c_true, args.repeats, dev)}), flush=True)

        keep = os.path.join(args.out, "cli_chain_features")
        shutil.rmtree(keep, ignore_errors=True)
        os.makedirs(keep)
        for name in ("cameraInit.sfm", "pairs.txt", "matches.npz"):
            shutil.copy(os.path.join(dsp, name), keep)
        shutil.copytree(os.path.join(dsp, "features"), os.path.join(keep, "features"))
        with open(os.path.join(keep, "device.txt"), "w") as f:
            f.write(smi + "\n")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
