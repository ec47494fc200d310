#!/usr/bin/env python3
"""Where the time of the port's depth-map estimation goes, on one GPU.

    python3 scripts/profile_dense_torch.py [--out DIR]

from the repository root, on a machine with a CUDA card. It renders the
scene of chip_smoke.py's main path (8 views of 1280x960, 640x480 maps,
D = 256, T = 4), then

1. times `sgm_aggregate` on a (D, 480, 640) cost volume at D = 96 (the
   runner's default), 256 and 320 with CUDA events, beside the kernel
   launches it makes, timed alone on the same volume, and its transpose to
   (H, W, D) alone: the difference is the work around the kernel (the
   transpose and P2). Then times `sgm_directional_pass` at chip_smoke.py's
   TIMED_SHAPES, one launch between two events (PR 1-3's series) and per
   launch over 10 back-to-back launches;
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
import statistics
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


def time_ms(fn, reps=10, inner=10):
    """Median over `reps` CUDA-event timings of `inner` back-to-back calls,
    per call, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def aggregate_breakdown(dev, D, H=480, W=640):
    rng = np.random.RandomState(0)
    cost = torch.from_numpy((rng.rand(D, H, W) * 255).astype(np.float32)).to(dev)
    img = torch.from_numpy(rng.rand(H, W).astype(np.float32)).to(dev)
    vol = cost.permute(1, 2, 0).contiguous()
    p2x, p2y = (torch.from_numpy((rng.rand(H, W) * 90 + 10).astype(np.float32)).to(dev)
                for _ in range(2))

    def kernels():
        total = sgm_kernel.sgm_axis_sweeps(vol, p2x, 10.0, 1)
        sgm_kernel.sgm_axis_sweeps(vol, p2y, 10.0, 0, total)

    before = sgm_kernel.launches["sgm_axis_sweeps"]
    kernels()
    n_launches = sgm_kernel.launches["sgm_axis_sweeps"] - before
    t_agg = time_ms(lambda: sgm_aggregate(cost, img, SgmParams()))
    t_k = time_ms(kernels)
    return {
        "shape": [D, H, W],
        "sgm_aggregate_ms": t_agg,
        "kernel_launches": n_launches,
        "kernels_ms": t_k,
        "around_kernel_ms": t_agg - t_k,
        "transpose_ms": time_ms(lambda: cost.permute(1, 2, 0).contiguous()),
    }


def kernel_times(dev):
    """sgm_directional_pass at chip_smoke.TIMED_SHAPES, ms a launch."""
    rows = []
    for S, N, D in chip_smoke.TIMED_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(S * 100003 + N * 101 + D)
        cost = torch.rand((S, N, D), generator=gen, device=dev) * 100
        p2 = torch.rand((S, N), generator=gen, device=dev) * 50 + 10

        def kernel():
            sgm_kernel.sgm_directional_pass(cost, p2, 10.0)

        rows.append({"shape": [S, N, D], "kernel_ms": time_ms(kernel, reps=20, inner=1),
                     "kernel_ms_back_to_back": time_ms(kernel)})
        del cost, p2
    return rows


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
    sgm_ms = sum(r[1] for r in rows if "sgm_sweep_" in r[0])
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
    for D in (96, 256, 320):
        print("aggregate " + json.dumps(aggregate_breakdown(dev, D)), flush=True)
    print("kernel " + json.dumps(kernel_times(dev)), flush=True)
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
