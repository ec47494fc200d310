#!/usr/bin/env python3
"""Where the time of the port's depth-map estimation goes, on one GPU.

    python3 scripts/profile_dense_torch.py [--out DIR]

from the repository root, on a machine with a CUDA card. It renders the
scene of chip_smoke.py's main path (8 views of 1280x960, 640x480 maps,
D = 256, T = 4), then

1. times `sgm_aggregate` on a (256, 480, 640) cost volume with CUDA events
   beside its two kernel launches alone: the difference is the cost of the
   transposes, flips, concatenations and sums around the kernel;
2. traces one view's `depth_map_estimation` with torch.profiler (after one
   view of warm-up) and prints the device time by kernel, the device's
   busy share of the stage's wall time and the SGM kernel's share.

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

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from alicevision_tpu_torch.mvs.plane_sweep import SgmParams, sgm_aggregate  # noqa: E402
from alicevision_tpu_torch.ops import sgm_kernel  # noqa: E402
from alicevision_tpu_torch.pipeline import stages  # noqa: E402


def aggregate_breakdown(dev, D=256, H=480, W=640, reps=20):
    rng = np.random.RandomState(0)
    cost = torch.from_numpy((rng.rand(D, H, W) * 255).astype(np.float32)).to(dev)
    img = torch.from_numpy(rng.rand(H, W).astype(np.float32)).to(dev)
    c_h = torch.from_numpy((rng.rand(W, 2 * H, D) * 255).astype(np.float32)).to(dev)
    p_h = torch.from_numpy((rng.rand(W, 2 * H) * 90 + 10).astype(np.float32)).to(dev)
    c_v = torch.from_numpy((rng.rand(H, 2 * W, D) * 255).astype(np.float32)).to(dev)
    p_v = torch.from_numpy((rng.rand(H, 2 * W) * 90 + 10).astype(np.float32)).to(dev)
    t_agg = chip_smoke._time_ms(lambda: sgm_aggregate(cost, img, SgmParams()), reps)
    t_h = chip_smoke._time_ms(lambda: sgm_kernel.sgm_directional_pass(c_h, p_h, 10.0), reps)
    t_v = chip_smoke._time_ms(lambda: sgm_kernel.sgm_directional_pass(c_v, p_v, 10.0), reps)
    return {
        "shape": [D, H, W],
        "sgm_aggregate_ms": t_agg,
        "kernel_h_ms": t_h,
        "kernel_v_ms": t_v,
        "around_kernel_ms": t_agg - t_h - t_v,
    }


def trace_one_view(sfm, dense, work, dev, out_dir):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # warm-up: view index 0 (cuFFT plans, cuBLAS handles, the kernel's load)
    stages.depth_map_estimation(
        sfm, dense, os.path.join(work, "warm"), n_depths=256, range_size=1, device=dev
    )
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stages.depth_map_estimation(
            sfm, dense, os.path.join(work, "traced"), n_depths=256,
            range_start=1, range_size=1, device=dev,
        )
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only: an operator's row repeats its kernels' time
    rows = sorted(
        ((e.key, dev_us(e) / 1e3, e.count) for e in events
         if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
        key=lambda r: -r[1],
    )
    busy_ms = sum(r[1] for r in rows)
    sgm_ms = sum(r[1] for r in rows if "sgm_directional_kernel" in r[0])
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "profile_dense_view.txt"), "w") as f:
            f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "sgm_kernel_ms": sgm_ms,
        "top_kernels": [{"kernel": k[:90], "device_ms": ms, "count": n} for k, ms, n in rows[:15]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for the profiler's table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_dense_torch.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    print("aggregate " + json.dumps(aggregate_breakdown(dev)), flush=True)
    work = tempfile.mkdtemp(prefix=".chip_smoke_profile_", dir=ROOT)
    try:
        sfm, _ = chip_smoke.make_posed_scene(work)
        dense = os.path.join(work, "dense")
        stages.prepare_dense_scene(sfm, dense, device=dev)
        print("view " + json.dumps(trace_one_view(sfm, dense, work, dev, args.out)), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
