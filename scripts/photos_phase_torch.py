#!/usr/bin/env python3
"""chip_smoke.py's `photos` phase and the pipeline phase's focal split,
alone, on one CUDA card (or `--device cpu`).

    python3 scripts/photos_phase_torch.py [--out chiprun_out] [--device cuda]

Renders the pipeline phase's 8-view scene, runs `run_full_pipeline` on its
`.npy` images once, prints the `pipeline focal split` line (the CPU front
end's fixture and this run's front end, each through the CPU engine and
this device's), then the `photos` phase (the JPEG fixtures, the 24 MP round
trip, the pipeline from camera JPEGs, the JAX photo test's 40 views) and
the gates it misses. Exits 1 when a gate is missed. With `--out`, writes
the photos row to `OUT/photos_phase.json`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from alicevision_tpu_torch import native  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    smi = ""
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        chip_smoke.build.build_all()
    print(smi, flush=True)
    t0 = time.perf_counter()
    native.build(native.JPEG_SRC)
    print(f"build native/jpeg.cpp: {time.perf_counter() - t0:.2f} s", flush=True)
    work = tempfile.mkdtemp(prefix=".photos_phase_", dir=chip_smoke.ROOT)
    try:
        t0 = time.perf_counter()
        sfm, gt = chip_smoke.make_posed_scene(work, n_views=8)
        images = os.path.join(work, "images")
        print(f"scene in {time.perf_counter() - t0:.1f} s", flush=True)
        out = os.path.join(work, "pipe")
        seconds, launches = chip_smoke.run_pipeline(out, images, dev)
        truth = chip_smoke.sfmdata.load(sfm)
        rep = chip_smoke.pipeline_report(out, truth.pose_R[truth.view_pose], truth.pose_c[truth.view_pose], gt)
        print("pipeline (npy) " + json.dumps({"stage_seconds": seconds, "sgm_launches": launches,
                                              "focal_px": rep["focal_px"], "n_posed": rep["n_posed"]}), flush=True)
        split = chip_smoke.focal_split(dev, work, out, rep["focal_px"])
        print("pipeline focal split " + json.dumps(split), flush=True)
        row, photo_launches = chip_smoke.run_photos_phase(dev, work, images, sfm, gt, seconds, smi)
        row["misses"] = chip_smoke.photos_misses(row)
        print("photos " + json.dumps(row), flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "photos_phase.json"), "w") as f:
                json.dump({"photos": row, "focal_split": split, "npy_seconds": seconds}, f, indent=1)
        print("misses: " + json.dumps(row["misses"]), flush=True)
        return 1 if row["misses"] else 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
