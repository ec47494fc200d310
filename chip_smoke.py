#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's dense depth-map path and its bundle
adjuster once on one GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit (`nvcc`). It

1. prints the card's name and power limit (nvidia-smi) and turns TF32 off;
2. builds every CUDA source of the port (`alicevision_tpu_torch/csrc/`);
3. holds the SGM kernel against its plain PyTorch version on the card at
   the reference's test shapes, ragged ones, D past 256 (257, 512, 1500:
   more register chunks, then the carry in shared memory) and the two
   shapes of the dense path, and times both at the latter (and at D = 512
   and 1500) with CUDA events beside the bandwidth bound;
4. renders a posed 8-view 1280x960 scene, writes it as `.npy` images plus a
   pinhole `.sfm`, and runs the port's four dense stages on it
   (prepareDenseScene -> depthMapEstimation at 640x480, D = 256, T = 4 ->
   depthMapFiltering -> meshing) and one more depth map at D = 320,
   checking that every SGM sweep of the path went through the kernel and
   that the depth maps meet the floors of tests/test_golden_mvs.py against
   the rendered ground truth;
5. runs the bundle adjuster (`sfm/ba.py`) at the two problem sizes of
   bench.py — 100 cameras / 10k landmarks through the dense Schur solve and
   1024 cameras / 300k landmarks through matrix-free PCG — timing LM
   iterations per second and checking convergence, then solves a mid-size
   problem on the CPU and on the card and holds the two results together;
6. prints a `ba` and a `kernels` JSON line and, last,
   `{"ok": true, "device": ...}`.

Every failed check raises, so the script exits non-zero and prints no result.
It needs a CUDA device; `make_posed_scene`, `run_main_path` and the BA
problem builders also run on the CPU at small sizes (the port's tests call
them so).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import tempfile
import time
import warnings

import numpy as np
import torch

from alicevision_tpu_torch import camera as cam
from alicevision_tpu_torch import sfmdata
from alicevision_tpu_torch.geometry import mat_to_quat, quat_to_mat
from alicevision_tpu_torch.mvs.plane_sweep import _directional_pass
from alicevision_tpu_torch.ops import build, sgm_kernel
from alicevision_tpu_torch.pipeline import stages
from alicevision_tpu_torch.sfm import ba
from alicevision_tpu_torch.utils.rendered import render_views, sample_surface_points
from alicevision_tpu_torch.utils.synthetic import ring_scene

ROOT = os.path.dirname(os.path.abspath(__file__))

# The reference's kernel test shapes; D not a multiple of 4 (the scalar
# load path, two chunks) and D = 1; D past 256 (three and four register
# chunks, then the shared-memory carry, vector and scalar loads, up to the
# reference's default of 1500 planes); then the two sweeps of one 640x480
# depth map at D = 256: horizontal (W, 2H, D) and vertical (H, 2W, D), and
# the horizontal sweep at D = 512 and 1500.
PATH_SHAPES = [(640, 960, 256), (480, 1280, 256)]
WIDE_SHAPES = [(640, 960, 512), (640, 960, 1500)]
KERNEL_SHAPES = (
    [(7, 13, 100), (12, 16, 256), (9, 11, 131), (4, 5, 1)]
    + [(5, 7, 257), (6, 9, 512), (4, 6, 1500), (5, 7, 1001)]
    + PATH_SHAPES + WIDE_SHAPES
)
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
        gen = torch.Generator(device=dev).manual_seed(S * 100003 + N * 101 + D)
        cost = torch.rand((S, N, D), generator=gen, device=dev) * 100
        p2 = torch.rand((S, N), generator=gen, device=dev) * 50 + 10
        out = sgm_kernel.sgm_directional_pass(cost, p2, P1)
        ref = _directional_pass(cost, p2, P1)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
        row = {"shape": [S, N, D], "max_abs_diff": err}
        if (S, N, D) in PATH_SHAPES + WIDE_SHAPES:
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

# ------------------------------------------------------------------- BA

# Checks of the BA phase: the headline problem's observations are
# noise-free, so 10 LM iterations reach sub-0.05 px; CPU and card solve the
# mid-size problem to final costs within rtol 1e-3 and positions within
# 1e-4 of the scene radius (float32 sums in another order, and the card's
# atomics, move the optimum by far less).
BA_HEADLINE_RMS_PX = 0.05
BA_CPU_CARD_RTOL = 1e-3
BA_CPU_CARD_POS = 1e-4


def _ring_problem(n_views, n_points, max_track, seed, device, radius=8.0, noise_px=0.0,
                  select="random"):
    """A ring scene as a BA problem: up to max_track observing views a point
    (random ones, as bench.py, or the first ones), points perturbed by 0.02,
    cameras 0-1 held. Drawn on the host, then placed on `device`."""
    scene = ring_scene(n_views=n_views, n_points=n_points, radius=radius, noise_px=noise_px,
                       seed=seed, device="cpu")
    vis = scene.visible.numpy()
    obs = scene.observations.numpy()
    rng = np.random.RandomState(seed)
    if select == "random":
        score = rng.rand(n_views, n_points) + vis
        order = np.argsort(-score, axis=0)[:max_track]  # (K, L) view indices
        keep = np.take_along_axis(vis, order, axis=0) & (vis.sum(0) >= 2)[None, :]
        o_cam = order[keep]
        o_lm = np.broadcast_to(np.arange(n_points), order.shape)[keep]
    else:
        o_cam, o_lm = np.nonzero(vis & (np.cumsum(vis, axis=0) <= max_track))
    intr = cam.Intrinsics(*(x[None] for x in scene.intrinsics))
    pts0 = scene.points.numpy() + 0.02 * rng.standard_normal((n_points, 3)).astype(np.float32)
    return ba.build_problem(
        scene.poses.q, scene.poses.c, pts0, intr, o_lm, o_cam,
        np.zeros(len(o_lm), np.int32), obs[o_cam, o_lm],
        max_track=max_track, cam_fixed=np.arange(n_views) < 2, device=device,
    )


def make_headline_problem(device, n_views=100, n_points=10_000, max_track=8, seed=0):
    """bench.py's headline: a 100-camera ring, 10k landmarks, up to 8 random
    observing views each, noise-free observations."""
    return _ring_problem(n_views, n_points, max_track, seed, device)


def make_large_problem(device, C=1024, L=300_000, K=6, seed=0):
    """bench.py's large problem: C cameras on a wavy ring, L landmarks, each
    seen by K distinct cameras from a 32-camera window near its angle
    (banded covisibility), 0.5 px observation noise, built in numpy."""
    rng = np.random.RandomState(seed)
    ang = np.linspace(0, 2 * np.pi, C, endpoint=False)
    centers = np.stack([10.0 * np.cos(ang), 10.0 * np.sin(ang), 0.5 * np.sin(3 * ang)], -1)
    fwd = -centers / np.linalg.norm(centers, axis=-1, keepdims=True)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    R = np.stack([right, np.cross(fwd, right), fwd], axis=-2)  # world->cam rows

    pts = rng.uniform(-1, 1, (L, 3)) * np.array([3.0, 3.0, 1.5])
    theta = np.arctan2(pts[:, 1], pts[:, 0])
    base = ((theta + np.pi) / (2 * np.pi) * C).astype(np.int64)
    WIN = 32
    cam_idx = (base[:, None] + np.argsort(rng.rand(L, WIN), axis=1)[:, :K] - WIN // 2) % C

    f, w_img, h_img = 1200.0, 1920.0, 1080.0
    u = np.einsum("lkij,lkj->lki", R[cam_idx], pts[:, None, :] - centers[cam_idx])
    z = u[..., 2]
    uv = f * u[..., :2] / np.where(np.abs(z) < 1e-9, 1e-9, z)[..., None] + np.array([w_img / 2, h_img / 2])
    ok = (z > 1.0) & (np.abs(uv[..., 0] - w_img / 2) < w_img / 2) & (np.abs(uv[..., 1] - h_img / 2) < h_img / 2)
    o_lm = np.broadcast_to(np.arange(L)[:, None], cam_idx.shape)[ok]
    o_cam = cam_idx[ok]
    o_uv = (uv + rng.normal(0, 0.5, uv.shape))[ok]
    q = mat_to_quat(torch.from_numpy(R.astype(np.float32)))
    intr = cam.Intrinsics(*(x[None] for x in cam.make_intrinsics(w_img, h_img, f)))
    pts0 = pts + rng.normal(0, 0.02, pts.shape)
    return ba.build_problem(q, centers, pts0, intr, o_lm, o_cam, np.zeros(len(o_lm), np.int32), o_uv,
                            max_track=K, cam_fixed=np.arange(C) < 2, device=device)


def make_mid_problem(device, n_views=24, n_points=2000, max_track=6, noise_px=0.3, seed=0):
    """The CPU-vs-card problem: 24 cameras, 2000 landmarks, up to 6 views
    each (the first ones), 0.3 px noise."""
    return _ring_problem(n_views, n_points, max_track, seed, device, radius=5.0,
                         noise_px=noise_px, select="first")


def problem_to(problem, device):
    """The same problem with every tensor on `device`."""
    def move(x):
        return None if x is None else x.to(device)

    return ba.BAProblem(*(cam.Intrinsics(*map(move, v)) if k == "intr" else move(v)
                          for k, v in problem._asdict().items()))


def _count_syncs(fn):
    """fn() with CUDA's synchronization debug mode on: returns (result,
    number of operations that made the host wait for the device)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def run_ba(name, problem, solve_kw, reps: int = 3) -> dict:
    """One warm-up solve (with its host syncs counted), then `reps` timed
    solves; LM iterations per second from the median wall time."""
    dev = problem.cam_c.device
    rms0 = float(ba.rms_reprojection_error(problem, problem.cam_q, problem.cam_c, problem.points))
    torch.cuda.synchronize()
    ba.host_syncs = 0
    res, syncs = _count_syncs(lambda: ba.ba_solve(problem, **solve_kw))
    loop_reads = ba.host_syncs
    times = []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ba.ba_solve(problem, **solve_kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    n_iters = int(res.n_iters)
    row = {
        "problem": name,
        "cameras": int(problem.cam_q.shape[0]),
        "landmarks": int(problem.points.shape[0]),
        "observations": int(problem.obs_mask.sum()),
        "solve": {k: v for k, v in solve_kw.items()},
        "n_iters": n_iters,
        "lm_iters_per_s": n_iters / statistics.median(times),
        "solve_s": times,
        "cost_initial": float(res.cost_initial),
        "cost_final": float(res.cost_final),
        "rms_px_before": rms0,
        "rms_px_after": float(ba.rms_reprojection_error(problem, res.cam_q, res.cam_c, res.points)),
        "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "host_syncs_per_lm_iter": syncs / max(n_iters, 1),
        "loop_reads_per_lm_iter": loop_reads / max(n_iters, 1),
    }
    print(f"ba {name} " + json.dumps(row), flush=True)
    return row


def check_ba(dev) -> list:
    """The BA phase: both bench problems on the card, then CPU vs card."""
    rows = []
    t0 = time.perf_counter()
    head = make_headline_problem(dev)
    print(f"ba headline problem built in {time.perf_counter() - t0:.2f} s", flush=True)
    r = run_ba("headline", head, dict(max_iters=10, rtol=0.0, solver="dense", loop="unrolled"))
    if not (math.isfinite(r["cost_final"]) and r["rms_px_after"] < BA_HEADLINE_RMS_PX):
        raise RuntimeError(f"headline BA: RMS {r['rms_px_after']} px after 10 iterations, "
                           f"expected below {BA_HEADLINE_RMS_PX}")
    rows.append(r)
    del head

    t0 = time.perf_counter()
    large = make_large_problem(dev)
    print(f"ba large problem built in {time.perf_counter() - t0:.2f} s", flush=True)
    r = run_ba("large", large, dict(max_iters=3, rtol=0.0, solver="pcg", cg_iters=8, loop="unrolled"))
    if not (math.isfinite(r["cost_initial"]) and math.isfinite(r["cost_final"])
            and r["cost_final"] < r["cost_initial"]):
        raise RuntimeError(f"large BA: cost {r['cost_initial']} -> {r['cost_final']}")
    rows.append(r)
    del large

    mid_cpu = make_mid_problem("cpu")
    mid_card = problem_to(mid_cpu, dev)
    res_cpu = ba.ba_solve(mid_cpu, max_iters=25)
    res_card = ba.ba_solve(mid_card, max_iters=25)
    radius = 5.0
    cmp = {
        "problem": "mid", "cameras": int(mid_cpu.cam_q.shape[0]),
        "landmarks": int(mid_cpu.points.shape[0]),
        "solver": ba._auto_solver(mid_cpu.cam_q.shape[0], mid_cpu.points.shape[0]),
        "cost_final_cpu": float(res_cpu.cost_final), "cost_final_card": float(res_card.cost_final),
        "n_iters_cpu": int(res_cpu.n_iters), "n_iters_card": int(res_card.n_iters),
        "max_center_diff": float((res_card.cam_c.cpu() - res_cpu.cam_c).abs().max()),
        "max_point_diff": float((res_card.points.cpu() - res_cpu.points).abs().max()),
        "max_rotation_diff": float((quat_to_mat(res_card.cam_q.cpu()) - quat_to_mat(res_cpu.cam_q)).abs().max()),
    }
    print("ba cpu_vs_card " + json.dumps(cmp), flush=True)
    ok = (
        math.isclose(cmp["cost_final_card"], cmp["cost_final_cpu"], rel_tol=BA_CPU_CARD_RTOL)
        and cmp["max_center_diff"] < BA_CPU_CARD_POS * radius
        and cmp["max_point_diff"] < BA_CPU_CARD_POS * radius
        and cmp["max_rotation_diff"] < BA_CPU_CARD_POS
    )
    if not ok:
        raise RuntimeError(f"BA on the card disagrees with the CPU: {cmp}")
    rows.append(cmp)
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
        # one more depth map of view 1 at D = 320 (three register chunks)
        depth320 = os.path.join(work, "depth320")
        t0 = time.perf_counter()
        stages.depth_map_estimation(sfm, res["dense"], depth320, n_depths=320, n_tcams=4,
                                    downscale=2, range_start=0, range_size=1, device=dev)
        torch.cuda.synchronize()
        res["seconds"]["depthMapEstimation_D320_one_view"] = time.perf_counter() - t0
        launches = sgm_kernel.launches
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        print("stage seconds " + json.dumps(res["seconds"]), flush=True)
        print(f"peak device memory: {peak_gib:.2f} GiB", flush=True)

        if launches != 2 * n_views + 2:
            raise RuntimeError(f"SGM kernel launched {launches} times, expected {2 * n_views + 2}")
        maps = [(v, res["depth"], "D=256") for v in range(n_views)] + [(0, depth320, "D=320")]
        for v, folder, label in maps:
            path = os.path.join(folder, f"{v + 1}_depth.npy")
            if not os.path.exists(path):
                raise RuntimeError(f"view {v + 1} ({label}) wrote no depth map")
            depth = np.load(path)
            gt_v = gt[v, ::2, ::2]
            if depth.shape != gt_v.shape or not np.isfinite(depth).all():
                raise RuntimeError(f"view {v + 1}: depth map {depth.shape} not finite or not {gt_v.shape}")
            med, frac = depth_stats(depth, gt_v)
            print(f"view {v + 1} {label}: median rel depth err {med:.5f}, valid frac {frac:.3f}", flush=True)
            if not (med < 0.01 and frac > 0.30):
                raise RuntimeError(f"view {v + 1} ({label}) misses the depth floors (<0.01, >0.30)")
        with open(res["ply"]) as f:
            header = [next(f) for _ in range(3)]
        n_ply = int(header[2].split()[-1])
        print(f"cloud.ply: {n_ply} points", flush=True)
        if n_ply != res["n_points"] or n_ply <= 5000:
            raise RuntimeError(f"cloud.ply holds {n_ply} points, expected more than 5000")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 5. the bundle adjuster
    ba_rows = check_ba(dev)

    # 6. results
    print(json.dumps({"ba": ba_rows}), flush=True)
    path_rows = [r for r in rows if tuple(r["shape"]) in PATH_SHAPES]
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
