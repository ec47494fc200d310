#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's dense depth-map path once on one GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit (`nvcc`). It

1. prints the card's name and power limit (nvidia-smi) and turns TF32 off;
2. builds every CUDA source of the port (`alicevision_tpu_torch/csrc/`);
3. holds the SGM kernel against its plain PyTorch version on the card at
   the reference's test shapes, two ragged ones and the two shapes of the
   dense path, and times both at the latter with CUDA events beside the
   bandwidth bound;
4. renders a posed 8-view 1280x960 scene, writes it as `.npy` images plus a
   pinhole `.sfm`, and runs the port's four dense stages on it
   (prepareDenseScene -> depthMapEstimation at 640x480, D = 256, T = 4 ->
   depthMapFiltering -> meshing), checking that every SGM sweep of the path
   went through the kernel and that the depth maps meet the floors of
   tests/test_golden_mvs.py against the rendered ground truth;
5. prints a `kernels` JSON line and, last, `{"ok": true, "device": ...}`.

Every failed check raises, so the script exits non-zero and prints no result.
It needs a CUDA device; `make_posed_scene` and `run_main_path` also run on
the CPU at small sizes (the port's tests call them so).
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from alicevision_tpu_torch import sfmdata
from alicevision_tpu_torch.mvs.plane_sweep import _directional_pass
from alicevision_tpu_torch.ops import build, sgm_kernel
from alicevision_tpu_torch.pipeline import stages
from alicevision_tpu_torch.utils.rendered import render_views, sample_surface_points

ROOT = os.path.dirname(os.path.abspath(__file__))

# The reference's kernel test shapes; D not a multiple of 4 (the scalar
# load path, two chunks) and D = 1; then the two sweeps of one 640x480 depth
# map at D = 256: horizontal (W, 2H, D) and vertical (H, 2W, D).
PATH_SHAPES = [(640, 960, 256), (480, 1280, 256)]
KERNEL_SHAPES = [(7, 13, 100), (12, 16, 256), (9, 11, 131), (4, 5, 1)] + PATH_SHAPES
ATOL, RTOL = 1e-3, 1e-5  # tests/test_pallas_sgm.py; 0 difference expected
P1 = 10.0

# NVIDIA H100 SXM data sheet at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SGM_OPS_PER_ELEMENT = 7  # neighbour min, +P1, two mins, +C, -m, share of min_d


def make_posed_scene(
    folder: str,
    n_views: int = 8,
    wh=(1280, 960),
    focal_px: float = 1120.0,
    arc: float = 0.6,
    n_points: int = 3000,
    seed: int = 0,
):
    """Render a posed box-world scene into `folder`: `.npy` grayscale images
    and one pinhole `scene.sfm` with SfM-like landmarks. A landmark is
    observed in a view where its projected depth agrees with the rendered
    depth within 1%. Returns (path of the .sfm, GT depth maps (V, H, W))."""
    imgs, gt, K, R, c = render_views(n_views, wh, focal_px=focal_px, arc=arc, seed=seed)
    W, H = wh
    img_dir = os.path.join(folder, "images")
    os.makedirs(img_dir, exist_ok=True)
    sc = sfmdata.SfMData.empty()
    # pixel (x, y) of the renderer holds the ray through (x + 0.5, y + 0.5)
    # of K, so the principal point of the pixel grid is half a pixel up-left
    sc.add_intrinsic(1000, W, H, float(focal_px), offset=(-0.5, -0.5))
    pp = K[:2, 2] - 0.5
    for v in range(n_views):
        path = os.path.join(img_dir, f"{v + 1}.npy")
        np.save(path, imgs[v])
        vi = sc.add_view(v + 1, 0, W, H, path=path)
        sc.set_pose(vi, R[v], c[v])

    pts = sample_surface_points(n_points, seed=seed)
    obs_lm, obs_view, obs_uv = [], [], []
    for v in range(n_views):
        xc = (pts - c[v]) @ R[v].T
        z = xc[:, 2]
        zs = np.where(z > 1e-6, z, 1.0)
        uv = focal_px * xc[:, :2] / zs[:, None] + pp
        xi = np.round(uv[:, 0]).astype(np.int64)
        yi = np.round(uv[:, 1]).astype(np.int64)
        inside = (z > 0.1) & (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        g = gt[v, yi.clip(0, H - 1), xi.clip(0, W - 1)]
        idx = np.nonzero(inside & (g > 0) & (np.abs(g - z) < 0.01 * z))[0]
        obs_lm.append(idx)
        obs_view.append(np.full(len(idx), v))
        obs_uv.append(uv[idx])
    obs_lm = np.concatenate(obs_lm)
    seen, obs_lm = np.unique(obs_lm, return_inverse=True)  # observed landmarks only
    sc.set_structure(pts[seen], obs_lm, np.concatenate(obs_view), np.concatenate(obs_uv))
    sfm = os.path.join(folder, "scene.sfm")
    sfmdata.save(sc, sfm)
    return sfm, gt


def run_main_path(
    work: str,
    sfm: str,
    device,
    n_depths: int = 256,
    n_tcams: int = 4,
    downscale: int = 2,
    min_consistent: int = 2,
):
    """The port's four dense stages on `sfm`, writing under `work`. Returns
    the output paths, the number of fused points and each stage's seconds."""
    out = {
        "dense": os.path.join(work, "dense"),
        "depth": os.path.join(work, "depth"),
        "filtered": os.path.join(work, "filtered"),
        "ply": os.path.join(work, "cloud.ply"),
    }
    seconds = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return res

    timed("prepareDenseScene", stages.prepare_dense_scene, sfm, out["dense"], device=device)
    timed(
        "depthMapEstimation", stages.depth_map_estimation, sfm, out["dense"], out["depth"],
        n_depths=n_depths, n_tcams=n_tcams, downscale=downscale, device=device,
    )
    timed(
        "depthMapFiltering", stages.depth_map_filtering, sfm, out["depth"], out["filtered"],
        min_consistent=min_consistent, downscale=downscale, device=device,
    )
    pts = timed(
        "meshing", stages.meshing_point_cloud, sfm, out["filtered"], out["ply"],
        downscale=downscale, device=device,
    )
    out["n_points"] = len(pts)
    out["seconds"] = seconds
    return out


def depth_stats(depth: np.ndarray, gt: np.ndarray):
    """Median relative depth error and valid fraction on the interior
    [12:-12, 12:-12] of a GT map (tests/test_golden_mvs.py)."""
    interior = np.zeros(gt.shape, bool)
    interior[12:-12, 12:-12] = True
    valid = (depth > 0) & (gt > 0) & interior
    rel = np.abs(depth - gt)[valid] / gt[valid]
    return float(np.median(rel)), float(valid.mean())


def _time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn() after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_sgm_kernel(dev) -> list:
    """The kernel against its plain version at every shape; timings and the
    bound at the main path's shapes."""
    rows = []
    for S, N, D in KERNEL_SHAPES:
        rng = np.random.RandomState(S * 100003 + N * 101 + D)
        cost = torch.from_numpy(rng.rand(S, N, D).astype(np.float32) * 100).to(dev)
        p2 = torch.from_numpy(rng.rand(S, N).astype(np.float32) * 50 + 10).to(dev)
        out = sgm_kernel.sgm_directional_pass(cost, p2, P1)
        ref = _directional_pass(cost, p2, P1)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
        row = {"shape": [S, N, D], "max_abs_diff": err}
        if (S, N, D) in PATH_SHAPES:
            n_bytes = (2 * S * N * D + S * N) * 4
            n_ops = SGM_OPS_PER_ELEMENT * S * N * D
            bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            ops_ms = n_ops / F32_OPS_PER_S * 1e3
            row.update(
                kernel_ms=_time_ms(lambda: sgm_kernel.sgm_directional_pass(cost, p2, P1), 30),
                plain_ms=_time_ms(lambda: _directional_pass(cost, p2, P1), 20),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            )
        print("sgm_directional_pass " + json.dumps(row), flush=True)
        del cost, p2, out, ref
        rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        "tf32 off: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}",
        flush=True,
    )

    # 2. build every kernel of the port
    for name, (sec, log) in build.build_all().items():
        print(f"build {name}: {sec:.2f} s", flush=True)
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print("  " + line.strip(), flush=True)

    # 3. kernel against its plain version
    rows = check_sgm_kernel(dev)

    # 4. the main path
    work = tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT)
    try:
        t0 = time.perf_counter()
        n_views = 8
        sfm, gt = make_posed_scene(work, n_views=n_views)
        print(f"scene: {n_views} views 1280x960 rendered in {time.perf_counter() - t0:.2f} s", flush=True)
        torch.cuda.reset_peak_memory_stats(dev)
        sgm_kernel.launches = 0
        res = run_main_path(work, sfm, dev)
        launches = sgm_kernel.launches
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        print("stage seconds " + json.dumps(res["seconds"]), flush=True)
        print(f"peak device memory: {peak_gib:.2f} GiB", flush=True)

        if launches != 2 * n_views:
            raise RuntimeError(f"SGM kernel launched {launches} times, expected {2 * n_views}")
        for v in range(n_views):
            path = os.path.join(res["depth"], f"{v + 1}_depth.npy")
            if not os.path.exists(path):
                raise RuntimeError(f"view {v + 1} wrote no depth map")
            depth = np.load(path)
            gt_v = gt[v, ::2, ::2]
            if depth.shape != gt_v.shape or not np.isfinite(depth).all():
                raise RuntimeError(f"view {v + 1}: depth map {depth.shape} not finite or not {gt_v.shape}")
            med, frac = depth_stats(depth, gt_v)
            print(f"view {v + 1}: median rel depth err {med:.5f}, valid frac {frac:.3f}", flush=True)
            if not (med < 0.01 and frac > 0.30):
                raise RuntimeError(f"view {v + 1} misses the depth floors (<0.01, >0.30)")
        with open(res["ply"]) as f:
            header = [next(f) for _ in range(3)]
        n_ply = int(header[2].split()[-1])
        print(f"cloud.ply: {n_ply} points", flush=True)
        if n_ply != res["n_points"] or n_ply <= 5000:
            raise RuntimeError(f"cloud.ply holds {n_ply} points, expected more than 5000")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 5. results
    path_rows = [r for r in rows if "kernel_ms" in r]
    kernel_ms = sum(r["kernel_ms"] for r in path_rows)  # one depth map's two sweeps
    max_err = max(r["max_abs_diff"] for r in rows)
    print(json.dumps({"kernels": [{
        "name": "sgm_directional_pass",
        "route": "cuda",
        "source": "alicevision_tpu_torch/csrc/sgm_directional.cu",
        "replaces": "alicevision_tpu/ops/sgm_pallas.py:69",
        "launches": launches,
        "max_abs_err": max_err,
        "max_abs_diff": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": sum(r["plain_ms"] for r in path_rows),
        "bound_ms": sum(r["bound_ms"] for r in path_rows),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in path_rows) else "operations",
        "library_ms": None,
        "shapes": rows,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
