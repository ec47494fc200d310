#!/usr/bin/env python3
"""Where the time of the port's incremental SfM goes, on one GPU.

    python3 scripts/profile_sfm_torch.py [--scene arc|hard] [--out DIR]

from the repository root, on a machine with a CUDA card. On chip_smoke.py's
rendered 8-view 1280x960 arc (`--scene arc`, the default) it runs the four
front stages once (the runner's 4096 keypoints, 28 exhaustive pairs); on
the hard scene (`--scene hard`) it runs chip_smoke.py's images path (40
distorted 1280x960 views, DSP-SIFT at 10,000 keypoints, voctree pairs, the
8-px gate). Then the incrementalSfm stage on their files:

1. once as a warm-up, once with its host syncs counted (CUDA's
   synchronization debug mode), once under torch.profiler;
2. prints the stage's wall time, the engine's wall seconds by step
   (initial pair, resection, triangulation, BA, joint BA, normalization;
   each step ends in its one device-to-host copy), the BA and joint-BA
   solves and their LM iterations, the device time by kernel, the kernel
   launches and the device's busy share of the wall time.

Prints JSON lines; with --out, also writes the profiler's table there.
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

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from alicevision_tpu_torch.pipeline import stages  # noqa: E402


def profile_stage(fn, out_dir, scene: str) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    _, syncs = chip_smoke._count_syncs(fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    engine = stages.last_engine
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    rows = sorted(
        ((e.key, dev_us(e) / 1e3, e.count) for e in events if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
        key=lambda r: -r[1],
    )
    busy_ms = sum(r[1] for r in rows)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"profile_sfm_{scene}.txt"), "w") as f:
            f.write(events.table(sort_by="self_cuda_time_total", row_limit=80))
    hist = engine.res.history
    return {
        "wall_ms": wall_ms,
        "step_seconds": engine.seconds,
        "ba_solves": [h[1:] for h in hist if h[0] == "ba"],
        "joint_ba_solves": sum(h[0] == "refine_intrinsics" for h in hist),
        "resections": sum(h[0] == "resect" for h in hist),
        "posed": int(engine.res.posed.sum()),
        "landmarks": int(engine.res.point_valid.sum()),
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "kernel_launches": sum(r[2] for r in rows),
        "host_syncs": syncs,
        "top_kernels": [{"kernel": k[:90], "device_ms": ms, "count": n} for k, ms, n in rows[:20]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("arc", "hard"), default="arc",
                    help="the 8-view arc, or the hard scene's 40-view images path")
    ap.add_argument("--out", default=None, help="directory for the profiler's table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_sfm_torch.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    work = tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT)
    try:
        if args.scene == "hard":
            seconds, _, _, _ = chip_smoke.run_hard_images(work, dev)
            files = [os.path.join(work, f) for f in ("hard_cameraInit.sfm", "hard_features", "hard_matches.npz")]
            config = chip_smoke.hard_images_config()
        else:
            chip_smoke.make_posed_scene(work)
            front = chip_smoke.run_front(os.path.join(work, "front"), os.path.join(work, "images"), dev)
            seconds = front["seconds"]
            files, config = [front["sfm"], front["feats"], front["matches"]], None
        print("front_seconds " + json.dumps(seconds), flush=True)

        def stage():
            return stages.incremental_sfm(*files, os.path.join(work, "sfm.sfm"), config=config, device=dev)

        print("incremental_sfm " + json.dumps(profile_stage(stage, args.out, args.scene)), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
