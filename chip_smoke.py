#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's dense depth-map path, its SfM front end, its
whole main path (images to point cloud) and its bundle adjuster once on one
GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit (`nvcc`). It

1. prints the card's name and power limit (nvidia-smi) and turns TF32 off;
2. builds every CUDA source of the port (`alicevision_tpu_torch/csrc/`);
3. holds the SGM kernel's two entries against their plain PyTorch versions
   on the card: `sgm_directional_pass` at the reference's test shapes,
   ragged ones, D past 512 (the carry in shared memory, up to the
   reference's default of 1500 planes) and the stacked (S, N, D) sweeps of
   one 640x480 map at D = 96, 256, 320, 512 and 1500, timed there with CUDA
   events beside the bandwidth bound; then `sgm_axis_sweeps` and the card's
   `sgm_aggregate` (against the same function over the plain sweeps) on
   (D, H, W) volumes at D = 96, 256 and 320 (640x480), two ragged ones and
   one at D = 1500, with the aggregate's extra device memory (no flipped or
   concatenated copy) and, at 640x480, its time, its sweeps' time and the
   plain composite's; the sweeps also for a batch of two views;
4. renders a posed 8-view 1280x960 scene, writes it as `.npy` images plus a
   pinhole `.sfm`, and runs the port's four dense stages on it
   (prepareDenseScene -> depthMapEstimation at 640x480, D = 256, T = 4 ->
   depthMapFiltering -> meshing), the 8 depth maps again at the runner's
   D = 96 and one more map at D = 320, checking that every SGM sweep of the
   path went through the kernel (four launches a map) and that the depth
   maps meet the floors of tests/test_golden_mvs.py against the rendered
   ground truth;
5. runs the port's SfM front end on the same images (cameraInit ->
   featureExtraction at the runner's 4096 keypoints, resized to 1024x768 ->
   exhaustive imageMatching -> featureMatching with AC-RANSAC F), twice,
   timing the second (warm) run, and checks the keypoints per view, the
   inliers of each adjacent pair, the inliers' Sampson distance to the
   rendered poses' true epipolar geometry, and view 1's features on the
   CPU against the card's;
6. runs the port's `run_full_pipeline` on the same images, twice (cold,
   then warm): cameraInit -> featureExtraction -> imageMatching ->
   featureMatching -> incrementalSfm (tracks, 5-point initial pair, P3P
   resection, triangulation, BA and joint intrinsics BA) ->
   prepareDenseScene -> depthMapEstimation (D = 96) -> depthMapFiltering ->
   meshing, and checks the poses (similarity-aligned to the rendered ones),
   the landmarks, each posed view's depth map, the cloud and the SGM
   launches (four a map); then incrementalSfm once more with its host syncs
   counted;
7. runs the bundle adjuster (`sfm/ba.py`) at the two problem sizes of
   bench.py — 100 cameras / 10k landmarks through the dense Schur solve and
   1024 cameras / 300k landmarks through matrix-free PCG — timing LM
   iterations per second and checking convergence, then solves a mid-size
   problem on the CPU and on the card and holds the two results together;
8. prints a `front`, a `pipeline`, a `ba` and a `kernels` JSON line and,
   last, `{"ok": true, "device": ...}`.

Every failed check raises, so the script exits non-zero and prints no result.
It needs a CUDA device; `make_posed_scene`, `run_main_path`, `run_front`,
`front_report`, `run_pipeline`, `pipeline_report` and the BA problem
builders also run on the CPU at small sizes (the port's tests call them
so).
"""

from __future__ import annotations

import json
import math
import os
import re
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
from alicevision_tpu_torch.mvs import plane_sweep
from alicevision_tpu_torch.mvs.plane_sweep import _axis_sweeps, _directional_pass
from alicevision_tpu_torch.ops import build, sgm_kernel
from alicevision_tpu_torch.features import sift
from alicevision_tpu_torch.image.filtering import _resize_bilinear
from alicevision_tpu_torch.pipeline import stages
from alicevision_tpu_torch.sfm import ba
from alicevision_tpu_torch.utils.rendered import render_views, sample_surface_points
from alicevision_tpu_torch.utils.synthetic import ring_scene

ROOT = os.path.dirname(os.path.abspath(__file__))

# sgm_directional_pass (S, N, D): the reference's kernel test shapes; D not
# a multiple of 4 (4-byte copies) and D = 1; D past 256 (register widths 12
# and 16, then the shared-memory carry, 16- and 4-byte copies, up to the
# reference's default of 1500 planes); then the stacked sweeps of one
# 640x480 depth map as PR 1-3 ran them: at D = 256 horizontal (W, 2H, D) and
# vertical (H, 2W, D); the same two at D = 96 (the JAX runner's default);
# and the horizontal one at D = 320 (10 values a lane, on the width-12
# kernel), 512 and 1500.
PATH_SHAPES = [(640, 960, 256), (480, 1280, 256)]
D96_SHAPES = [(640, 960, 96), (480, 1280, 96)]
WIDE_SHAPES = [(640, 960, 320), (640, 960, 512), (640, 960, 1500)]
TIMED_SHAPES = PATH_SHAPES + D96_SHAPES + WIDE_SHAPES
KERNEL_SHAPES = (
    [(7, 13, 100), (12, 16, 256), (9, 11, 131), (4, 5, 1)]
    + [(5, 7, 257), (6, 9, 512), (4, 6, 1500), (5, 7, 1001)]
    + TIMED_SHAPES
)
# sgm_axis_sweeps and sgm_aggregate (D, H, W): one 640x480 map at each D of
# the main path (the runner's 96, then 256 and 320; timed), two ragged
# volumes, and D = 1500.
AGG_TIMED = [(96, 480, 640), (256, 480, 640), (320, 480, 640)]
AGG_SHAPES = AGG_TIMED + [(131, 37, 53), (3, 29, 41), (1500, 48, 64)]
ATOL, RTOL = 1e-3, 1e-5  # tests/test_pallas_sgm.py; 0 difference expected
P1 = 10.0
LAUNCHES_PER_MAP = 4  # sgm_aggregate: two sgm_axis_sweeps calls, two launches each
INNER = 10  # back-to-back calls timed between two events (see _time_ms)

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


def _time_ms(fn, reps: int, warmup: int = 3, inner: int = 1) -> float:
    """Median over `reps` CUDA-event timings of `inner` back-to-back calls of
    fn(), per call, after `warmup` calls. With inner = 1 (PR 1-3's method)
    the time includes the host's launch gap; with inner > 1 the host's
    launch work overlaps the device's, as on a path that keeps the card
    busy."""
    for _ in range(warmup):
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


def _bound(n_bytes: float, n_ops: float):
    """The least time (ms) the card could take: bytes over its memory rate or
    operations over its FP32 rate, whichever is larger, and which one."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def check_sgm_kernel(dev) -> list:
    """sgm_directional_pass against its plain version at every shape;
    timings and the bound at the timed shapes: `kernel_ms` one launch
    between two events (PR 1-3's series), `kernel_ms_back_to_back` per
    launch over INNER launches."""
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
        if (S, N, D) in TIMED_SHAPES:
            bound_ms, bound_by = _bound((2 * S * N * D + S * N) * 4, SGM_OPS_PER_ELEMENT * S * N * D)
            def kernel():
                sgm_kernel.sgm_directional_pass(cost, p2, P1)

            row.update(
                kernel_ms=_time_ms(kernel, 20),
                kernel_ms_back_to_back=_time_ms(kernel, 10, inner=INNER),
                plain_ms=_time_ms(lambda: _directional_pass(cost, p2, P1), 20),
                bound_ms=bound_ms,
                bound_by=bound_by,
            )
        print("sgm_directional_pass " + json.dumps(row), flush=True)
        del cost, p2, out, ref
        rows.append(row)
    return rows


def plain_aggregate(cost, img):
    """`sgm_aggregate` with the plain sweeps (`_axis_sweeps`) in place of the
    kernel's entry: the plain composite, on the tensors' device."""
    plane_sweep.sgm_axis_sweeps = _axis_sweeps
    try:
        return plane_sweep.sgm_aggregate(cost, img)
    finally:
        plane_sweep.sgm_axis_sweeps = sgm_kernel.sgm_axis_sweeps


def check_sgm_aggregate(dev) -> list:
    """sgm_axis_sweeps (both axes into one total) and the card's
    sgm_aggregate against the plain composite on the card at AGG_SHAPES,
    with the aggregate's extra device memory; at AGG_TIMED their times
    beside the bounds.

    Bounds, with V = D*H*W*4 bytes and P = H*W*4: the two sweep calls must
    read the volume twice and the total once and write the total twice
    (5V + 2P); their four launches move 11V + 4P (the first writes the
    total, three read and rewrite it). sgm_aggregate must read the cost
    and write the result (2V + P); with its one transpose it moves
    13V + 4P."""
    rows = []
    for D, H, W in AGG_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(D * 100003 + H * 101 + W)
        cost = torch.rand((D, H, W), generator=gen, device=dev) * 255
        img = torch.rand((H, W), generator=gen, device=dev)
        p2x = torch.rand((H, W), generator=gen, device=dev) * 90 + 10
        p2y = torch.rand((H, W), generator=gen, device=dev) * 90 + 10
        vol = cost.permute(1, 2, 0).contiguous()

        def sweeps():
            total = sgm_kernel.sgm_axis_sweeps(vol, p2x, P1, 1)
            return sgm_kernel.sgm_axis_sweeps(vol, p2y, P1, 0, total)

        def plain_sweeps():
            return _axis_sweeps(vol, p2y, P1, 0, _axis_sweeps(vol, p2x, P1, 1))

        out, ref = sweeps().flatten(), plain_sweeps().flatten()
        if (D, H, W) not in AGG_TIMED:  # and a batch of two views
            vols = torch.stack([vol, vol.flip(0).contiguous()])
            p2b = torch.stack([p2x, p2y])
            total = sgm_kernel.sgm_axis_sweeps(vols, p2b, P1, 1)
            total = sgm_kernel.sgm_axis_sweeps(vols, p2b, P1, 0, total)
            plain = [_axis_sweeps(v, p, P1, 0, _axis_sweeps(v, p, P1, 1)) for v, p in zip(vols, p2b)]
            out = torch.cat([out, total.flatten()])
            ref = torch.cat([ref, torch.stack(plain).flatten()])
        torch.cuda.synchronize()
        sweeps_err = float((out - ref).abs().max())
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
        del out, ref
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        agg = plane_sweep.sgm_aggregate(cost, img)
        extra = torch.cuda.max_memory_allocated(dev) - base
        ref = plain_aggregate(cost, img)
        torch.cuda.synchronize()
        agg_err = float((agg - ref).abs().max())
        torch.testing.assert_close(agg, ref, atol=ATOL, rtol=RTOL)
        del agg, ref
        V, P = D * H * W * 4, H * W * 4
        row = {
            "shape": [D, H, W],
            "sweeps_max_abs_diff": sweeps_err,
            "aggregate_max_abs_diff": agg_err,
            "aggregate_extra_memory_in_volumes": extra / V,
        }
        # the (H, W, D) copy and the total, and a few (H, W) planes for P2:
        # a flipped or concatenated copy of the volume would not fit
        if extra > 2 * V + 16 * P:
            raise RuntimeError(f"sgm_aggregate at {(D, H, W)} allocated {extra} bytes, more than 2V")
        if (D, H, W) in AGG_TIMED:
            n_ops = 4 * SGM_OPS_PER_ELEMENT * D * H * W
            sweeps_bound, sweeps_by = _bound(5 * V + 2 * P, n_ops)
            agg_bound, agg_by = _bound(2 * V + P, n_ops)
            row.update(
                sweeps_ms=_time_ms(sweeps, 10, inner=INNER),
                plain_sweeps_ms=_time_ms(plain_sweeps, 5),
                sweeps_bound_ms=sweeps_bound,
                sweeps_bound_by=sweeps_by,
                sweeps_design_bytes_ms=_bound(11 * V + 4 * P, 0)[0],
                aggregate_ms=_time_ms(lambda: plane_sweep.sgm_aggregate(cost, img), 10, inner=INNER),
                plain_aggregate_ms=_time_ms(lambda: plain_aggregate(cost, img), 5),
                aggregate_bound_ms=agg_bound,
                aggregate_bound_by=agg_by,
                aggregate_design_bytes_ms=_bound(13 * V + 4 * P, 0)[0],
            )
        print("sgm_aggregate " + json.dumps(row), flush=True)
        del cost, img, p2x, p2y, vol
        rows.append(row)
    return rows


# ------------------------------------------------------------ front end

# Checks of the front-end phase. The keypoint floor is set from a CPU run of
# the port on the same rendered scene (177-231 valid keypoints a view of
# the 4096 allowed: the box world's procedural texture is smooth, so few
# DoG extrema pass the contrast threshold); the CPU run found 94-135
# geometric inliers an adjacent pair. CPU and card extract view 1 from the
# same resized image; float32 sums in another order move a sub-pixel
# refinement by ~1e-4 px. The epipolar check measures the Sampson distance to the true
# geometry: of the CPU run's inliers, 97.7 % lie within 2 px by it (94.5 %
# by the one-sided point-to-line distance: ~5 % are mismatches of the
# repetitive texture that lie along the epipolar line, within the 4 px
# band, which no F filter can reject).
FRONT_MAX_KEYPOINTS = 4096  # the runner's (pipeline/runner.py)
FRONT_MIN_KEYPOINTS = 150
FRONT_MIN_INLIERS = 50
FRONT_EPI_PX, FRONT_EPI_FRAC = 2.0, 0.95
FRONT_CPU_CARD_PX, FRONT_CPU_CARD_FRAC, FRONT_CPU_CARD_DESC = 0.05, 0.95, 1e-3


def run_front(work: str, image_folder: str, device, focal_px: float = 1120.0,
              max_keypoints: int = FRONT_MAX_KEYPOINTS, downscale_to: int = 1024):
    """The port's four front stages on the images of `image_folder`,
    writing under `work`. Returns the output paths, each stage's seconds and
    the number of describer batches featureExtraction copied back."""
    out = {
        "sfm": os.path.join(work, "cameraInit.sfm"),
        "feats": os.path.join(work, "features"),
        "pairs": os.path.join(work, "pairs.txt"),
        "matches": os.path.join(work, "matches.npz"),
    }
    os.makedirs(work, exist_ok=True)
    seconds = {}
    cuda = torch.device(device).type == "cuda"

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        if cuda:
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return res

    timed("cameraInit", stages.camera_init, image_folder, out["sfm"], default_focal_px=focal_px,
          device=device)
    timed("featureExtraction", stages.feature_extraction, out["sfm"], out["feats"],
          max_keypoints=max_keypoints, downscale_to=downscale_to, device=device)
    out["extraction_batches"] = stages.extraction_host_copies
    timed("imageMatching", stages.image_matching, out["sfm"], out["feats"], out["pairs"],
          method="exhaustive", device=device)
    timed("featureMatching", stages.feature_matching, out["sfm"], out["feats"], out["pairs"],
          out["matches"], ratio=0.8, n_ransac_hyps=256, max_error_px=4.0, device=device)
    out["seconds"] = seconds
    return out


def fundamental_true(posed_sfm: str, i: int, j: int) -> np.ndarray:
    """F between views i and j of a posed scene in the images' pixel-array
    coordinates (the principal point of the `.sfm` includes the renderer's
    -0.5 px offset, as make_posed_scene writes it)."""
    sc = sfmdata.load(posed_sfm)
    k = int(sc.view_intrinsic[i])
    f = sc.scale[k]
    pp = sc.offset[k] + 0.5 * sc.sizes[k]
    Kinv = np.linalg.inv(np.array([[f[0], 0, pp[0]], [0, f[1], pp[1]], [0, 0, 1.0]]))
    Ri, Rj = sc.pose_R[int(sc.view_pose[i])], sc.pose_R[int(sc.view_pose[j])]
    ci, cj = sc.pose_c[int(sc.view_pose[i])], sc.pose_c[int(sc.view_pose[j])]
    R = Rj @ Ri.T
    t = Rj @ (ci - cj)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    return Kinv.T @ tx @ R @ Kinv


def epipolar_px(F: np.ndarray, x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """Symmetric (Sampson) epipolar distance of each correspondence under F,
    pixels: the residual AC-RANSAC scores (`multiview.epipolar_distance_sq`),
    in float64. One-sided point-to-line distances are about sqrt(2) times
    larger."""
    p1 = np.c_[x1, np.ones(len(x1))]
    p2 = np.c_[x2, np.ones(len(x2))]
    Fp1 = p1 @ F.T
    Ftp2 = p2 @ F
    num = np.sum(p2 * Fp1, 1) ** 2
    den = Fp1[:, 0] ** 2 + Fp1[:, 1] ** 2 + Ftp2[:, 0] ** 2 + Ftp2[:, 1] ** 2
    return np.sqrt(num / den)


def front_report(res: dict, posed_sfm: str, n_views: int) -> dict:
    """Keypoints per view, geometric inliers per pair, and their Sampson
    distances to the true epipolar geometry."""
    feats = [stages.load_features(res["feats"], v + 1) for v in range(n_views)]
    matches = stages.load_matches(res["matches"])
    dists = []
    inliers = {}
    for (i, j), pm in sorted(matches.items()):
        inliers[f"{i}_{j}"] = len(pm)
        if len(pm):
            F = fundamental_true(posed_sfm, i, j)
            dists.append(epipolar_px(F, feats[i]["xy"][pm[:, 0]], feats[j]["xy"][pm[:, 1]]))
    d = np.concatenate(dists) if dists else np.zeros(0)
    return {
        "keypoints_per_view": [int(f["valid"].sum()) for f in feats],
        "inliers_per_pair": inliers,
        "adjacent_inliers": [inliers.get(f"{v}_{v + 1}", 0) for v in range(n_views - 1)],
        "inliers_total": int(len(d)),
        "frac_within_2px_of_true_epipolar": float((d < FRONT_EPI_PX).mean()) if len(d) else 0.0,
        "median_sampson_px": float(np.median(d)) if len(d) else None,
    }


def compare_cpu_card(img: np.ndarray, dev, downscale_to: int = 1024) -> dict:
    """One view extracted on the CPU and on the card from the same image,
    resized as featureExtraction resizes it: the share of the CPU's valid
    keypoints with a card keypoint within FRONT_CPU_CARD_PX at the same
    orientation, and the largest descriptor difference among those."""
    cfg = sift.SiftConfig(max_keypoints=FRONT_MAX_KEYPOINTS, n_octaves=4)
    s = downscale_to / max(img.shape)
    size = (int(img.shape[1] * s), int(img.shape[0] * s))
    out = []
    for d in ("cpu", dev):
        x = _resize_bilinear(torch.from_numpy(img).to(d), size)
        f = sift.extract(x, cfg)
        out.append({k: getattr(f, k).cpu().numpy() for k in ("xy", "orientation", "desc", "valid")})
    a, b = out
    va, vb = a["valid"], b["valid"]
    dxy = np.linalg.norm(a["xy"][va][:, None] - b["xy"][vb][None], axis=-1)
    near, dist = dxy.argmin(1), dxy.min(1)
    dori = np.abs(np.angle(np.exp(1j * (b["orientation"][vb][near] - a["orientation"][va]))))
    same = (dist < FRONT_CPU_CARD_PX) & (dori < 1e-3)
    ddesc = np.abs(b["desc"][vb][near] - a["desc"][va])[same]
    return {
        "keypoints_cpu": int(va.sum()), "keypoints_card": int(vb.sum()),
        "frac_matched": float(same.mean()) if len(same) else 0.0,
        "max_xy_diff_matched": float(dist[same].max()) if same.any() else None,
        "max_desc_diff_matched": float(ddesc.max()) if ddesc.size else None,
    }


def check_front(dev, work: str, image_folder: str, posed_sfm: str, n_views: int) -> dict:
    """The front-end phase: a cold run, then a warm run timed and checked,
    featureExtraction once more with its host syncs counted, then view 1 on
    the CPU against the card."""
    cold = run_front(os.path.join(work, "front_cold"), image_folder, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    res = run_front(os.path.join(work, "front"), image_folder, dev)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    _, syncs = _count_syncs(lambda: stages.feature_extraction(
        res["sfm"], os.path.join(work, "front_syncs"), max_keypoints=FRONT_MAX_KEYPOINTS, device=dev))
    batches = stages.extraction_host_copies
    rep = front_report(res, posed_sfm, n_views)
    cmp = compare_cpu_card(np.load(os.path.join(image_folder, "1.npy")), dev)
    row = {
        "stage_seconds_warm": res["seconds"],
        "stage_seconds_cold": cold["seconds"],
        "extraction_batches": batches,
        "extraction_host_syncs": syncs,
        "extraction_host_syncs_per_batch": syncs / max(batches, 1),
        "peak_device_gib": peak_gib,
        **rep,
        "cpu_vs_card_view1": cmp,
    }
    print("front " + json.dumps(row), flush=True)
    bad = []
    if min(rep["keypoints_per_view"]) < FRONT_MIN_KEYPOINTS:
        bad.append(f"keypoints per view {rep['keypoints_per_view']} below {FRONT_MIN_KEYPOINTS}")
    if min(rep["adjacent_inliers"]) < FRONT_MIN_INLIERS:
        bad.append(f"adjacent-pair inliers {rep['adjacent_inliers']} below {FRONT_MIN_INLIERS}")
    if rep["frac_within_2px_of_true_epipolar"] < FRONT_EPI_FRAC:
        bad.append(f"{rep['frac_within_2px_of_true_epipolar']:.3f} of the inliers within "
                   f"{FRONT_EPI_PX} px (Sampson) of the true epipolar geometry, expected {FRONT_EPI_FRAC}")
    if cmp["frac_matched"] < FRONT_CPU_CARD_FRAC or not (
            cmp["max_desc_diff_matched"] is not None and cmp["max_desc_diff_matched"] < FRONT_CPU_CARD_DESC):
        bad.append(f"view 1 on the card disagrees with the CPU: {cmp}")
    if len(pairs := stages.load_pairs(res["pairs"])) != n_views * (n_views - 1) // 2:
        bad.append(f"imageMatching gave {len(pairs)} pairs")
    if bad:
        raise RuntimeError("front end: " + "; ".join(bad))
    return row

# ------------------------------------------------------------- pipeline

# Checks of the pipeline phase: the port's run_full_pipeline from the
# rendered `.npy` images to cloud.ply, with the runner's defaults (4096
# keypoints, exhaustive pairs, D = 96, T = 4, downscale 2) and the rendered
# focal. The JAX package posed all 8 views of this scene (236 landmarks,
# camera-centre ATE 0.22 % of the ring radius after a similarity
# alignment). Depth maps are scaled by the alignment's s. The dense
# phase's floors (median relative error < 0.01, valid > 0.30) hold for
# ground-truth poses; estimated ones carry the joint BA's refined
# intrinsics, and on this short arc the vertical focal is weakly observed:
# a CPU run of the port on these images (8 posed, 244 landmarks, ATE 0.21 %
# of the radius, rotations within 0.74 deg) refined (fx, fy) to (1129.7,
# 982.3) px for the true 1120, and its D = 96 maps reached median relative
# errors of 0.027-0.031 with 0.365-0.380 of the pixels valid. The JAX
# package's engine on the same matches refined them to (1158.4, 906.5).
# The depth floor is set from that run.
PIPE_MIN_POSED = 7
PIPE_ATE_FRAC = 0.01  # of the ring radius
PIPE_ROT_DEG = 1.0
PIPE_MIN_LANDMARKS = 100
PIPE_DEPTH_MED, PIPE_DEPTH_VALID = 0.05, 0.30
PIPE_MIN_CLOUD = 5000


def run_pipeline(work: str, image_folder: str, device, focal_px: float = 1120.0, **kw):
    """The port's run_full_pipeline on the images of `image_folder`, writing
    under `work`, with the SGM launch counts set to 0 just before it.
    Returns (stage seconds, the launches it made)."""
    from alicevision_tpu_torch.pipeline.runner import run_full_pipeline

    sgm_kernel.launches.update(dict.fromkeys(sgm_kernel.launches, 0))
    seconds = run_full_pipeline(image_folder, work, default_focal_px=focal_px, device=device, **kw)
    return seconds, dict(sgm_kernel.launches)


def _align_similarity(a: np.ndarray, b: np.ndarray):
    """Similarity (s, R, t) with s R a + t ~ b (Umeyama)."""
    mu_a, mu_b = a.mean(0), b.mean(0)
    ac, bc = a - mu_a, b - mu_b
    U, S, Vt = np.linalg.svd(bc.T @ ac / len(a))
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / ((ac**2).sum() / len(a))
    return s, R, mu_b - s * R @ mu_a


def pipeline_report(work: str, R_true: np.ndarray, c_true: np.ndarray, gt: np.ndarray, downscale: int = 2) -> dict:
    """The reconstruction in `work` against the rendered truth (view v is
    image v + 1): posed views, camera-centre ATE after a similarity
    alignment of the centres, rotation errors after the rotation that best
    aligns the orientations, each posed view's depth map
    scaled by the alignment's s against the rendered depth, landmarks,
    the refined focal and the cloud's points."""
    sc = sfmdata.load(os.path.join(work, "sfm.sfm"))
    posed = sc.valid_views()
    rows = sc.view_pose[posed]
    est_c, est_R = sc.pose_c[rows], sc.pose_R[rows]
    s, Ra, t = _align_similarity(est_c, c_true[posed])
    aligned = est_c @ (s * Ra).T + t
    ate = float(np.sqrt(np.mean(np.sum((aligned - c_true[posed]) ** 2, axis=1))))
    radius = float(np.linalg.norm(c_true[:, :2], axis=1).mean())
    # the rotation of the alignment from the orientations (their chordal
    # mean): centres on a short arc pin a tilt about its chord only weakly
    U, _, Vt = np.linalg.svd(np.einsum("vji,vjk->ik", R_true[posed], est_R))
    Ro = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt

    def angle(A):
        return float(np.degrees(np.arccos(np.clip((np.trace(A) - 1) / 2, -1, 1))))

    rot = [angle(Re @ Ro.T @ Rt.T) for Re, Rt in zip(est_R, R_true[posed])]
    depth_med, depth_valid = [], []
    for v in posed:
        d = np.load(os.path.join(work, "depth", f"{int(sc.view_ids[v])}_depth.npy"))
        gt_v = gt[v, ::downscale, ::downscale]
        if d.shape != gt_v.shape or not np.isfinite(d).all():
            raise RuntimeError(f"view {v + 1}: depth map {d.shape} not finite or not {gt_v.shape}")
        med, frac = depth_stats(d * s, gt_v)
        depth_med.append(med)
        depth_valid.append(frac)
    with open(os.path.join(work, "cloud.ply")) as f:
        header = [next(f) for _ in range(3)]
    return {
        "posed": [int(v) + 1 for v in posed],
        "n_posed": len(posed),
        "landmarks": int(sc.n_landmarks),
        "ate": ate,
        "ate_frac_of_radius": ate / radius,
        "rotation_err_deg": rot,
        "centre_vs_orientation_alignment_deg": angle(Ra @ Ro.T),
        "scale": float(s),
        "focal_px": sc.scale.tolist(),
        "depth_median_rel_err": depth_med,
        "depth_valid_frac": depth_valid,
        "cloud_points": int(header[2].split()[-1]),
    }


def check_pipeline(dev, work: str, image_folder: str, posed_sfm: str, gt: np.ndarray) -> tuple:
    """The pipeline phase: run_full_pipeline cold (first in the process)
    and warm, each with its SGM launches counted; the warm run checked
    against the rendered truth; incrementalSfm once more with its host
    syncs counted. Returns (the `pipeline` row, launches of both runs)."""
    truth = sfmdata.load(posed_sfm)
    R_true, c_true = truth.pose_R[truth.view_pose], truth.pose_c[truth.view_pose]
    cold, cold_launches = run_pipeline(os.path.join(work, "pipe_cold"), image_folder, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out = os.path.join(work, "pipe")
    warm, warm_launches = run_pipeline(out, image_folder, dev)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    engine = stages.last_engine
    kinds = [h[0] for h in engine.res.history]
    _, syncs = _count_syncs(lambda: stages.incremental_sfm(
        os.path.join(out, "cameraInit.sfm"), os.path.join(out, "features"), os.path.join(out, "matches.npz"),
        os.path.join(work, "pipe_syncs.sfm"), device=dev))
    rep = pipeline_report(out, R_true, c_true, gt)
    row = {
        "stage_seconds_warm": warm,
        "stage_seconds_cold": cold,
        "incremental_step_seconds_warm": engine.seconds,
        "ba_solves": kinds.count("ba"),
        "joint_ba_solves": kinds.count("refine_intrinsics"),
        "resections": kinds.count("resect"),
        "incremental_host_syncs": syncs,
        "peak_device_gib": peak_gib,
        "sgm_launches_cold": cold_launches,
        "sgm_launches_warm": warm_launches,
        **rep,
    }
    print("pipeline " + json.dumps(row), flush=True)
    bad = []
    for name, got in (("cold", cold_launches), ("warm", warm_launches)):
        maps = len(os.listdir(os.path.join(work, "pipe_cold" if name == "cold" else "pipe", "depth"))) // 2
        want = {"sgm_directional_pass": 0, "sgm_axis_sweeps": LAUNCHES_PER_MAP * maps}
        if got != want or maps != rep["n_posed"]:
            bad.append(f"{name} run: {maps} depth maps, SGM launches {got}, expected {want}")
    if rep["n_posed"] < PIPE_MIN_POSED:
        bad.append(f"{rep['n_posed']} views posed, expected at least {PIPE_MIN_POSED}")
    if rep["ate_frac_of_radius"] >= PIPE_ATE_FRAC:
        bad.append(f"camera-centre ATE {rep['ate_frac_of_radius']:.4f} of the radius, expected < {PIPE_ATE_FRAC}")
    if max(rep["rotation_err_deg"]) >= PIPE_ROT_DEG:
        bad.append(f"rotation errors {rep['rotation_err_deg']} deg, expected < {PIPE_ROT_DEG}")
    if rep["landmarks"] < PIPE_MIN_LANDMARKS:
        bad.append(f"{rep['landmarks']} landmarks, expected at least {PIPE_MIN_LANDMARKS}")
    missed = [v for v, m, f in zip(rep["posed"], rep["depth_median_rel_err"], rep["depth_valid_frac"])
              if not (m < PIPE_DEPTH_MED and f > PIPE_DEPTH_VALID)]
    if missed:
        bad.append(f"views {missed} miss the depth floors (<{PIPE_DEPTH_MED}, >{PIPE_DEPTH_VALID})")
    if rep["cloud_points"] <= PIPE_MIN_CLOUD:
        bad.append(f"cloud.ply holds {rep['cloud_points']} points, expected more than {PIPE_MIN_CLOUD}")
    if bad:
        raise RuntimeError("pipeline: " + "; ".join(bad))
    return row, {k: cold_launches[k] + warm_launches[k] for k in cold_launches}


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


def kernels_line(rows: list, agg_rows: list, launches: dict) -> dict:
    """The `kernels` entry of the SGM kernel, named after the entry the main
    path launches. Its numbers are one 640x480 D = 96 map's two
    sgm_axis_sweeps calls (four launches, per call pair over INNER
    back-to-back pairs), its bound the least traffic of those calls (5
    volumes), and the main path's launches. `entries` adds
    sgm_directional_pass, with PR 1-3's yardstick: one D = 256 map's two
    stacked sweeps, one launch between two events, against their bound."""
    path = [r for r in rows if tuple(r["shape"]) in PATH_SHAPES]
    map96 = next(r for r in agg_rows if tuple(r["shape"]) == AGG_TIMED[0])
    sweeps_err = max(max(r["sweeps_max_abs_diff"], r["aggregate_max_abs_diff"]) for r in agg_rows)
    return {
        "name": "sgm_axis_sweeps",
        "route": "cuda",
        "source": "alicevision_tpu_torch/csrc/sgm_directional.cu",
        "replaces": "alicevision_tpu/ops/sgm_pallas.py:69",
        "launches": launches["sgm_axis_sweeps"],
        "max_abs_err": sweeps_err,
        "ms": map96["sweeps_ms"],
        "plain_ms": map96["plain_sweeps_ms"],
        "bound_ms": map96["sweeps_bound_ms"],
        "bound_by": map96["sweeps_bound_by"],
        "library_ms": None,
        "aggregate": agg_rows,
        "entries": [{
            "name": "sgm_directional_pass",
            "launches": launches["sgm_directional_pass"],
            "max_abs_err": max(r["max_abs_diff"] for r in rows),
            "ms": sum(r["kernel_ms"] for r in path),
            "plain_ms": sum(r["plain_ms"] for r in path),
            "bound_ms": sum(r["bound_ms"] for r in path),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in path) else "operations",
            "library_ms": None,
            "shapes": rows,
        }],
    }


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
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
        print(f"build {name}: {sec:.2f} s, {len(regs)} kernels, at most {max(regs, default=0)} "
              f"registers a thread, spills: {spills or 'none'}", flush=True)

    # 3. kernel against its plain version, both entries
    rows = check_sgm_kernel(dev)
    agg_rows = check_sgm_aggregate(dev)

    # 4. the main path
    work = tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT)
    try:
        t0 = time.perf_counter()
        n_views = 8
        sfm, gt = make_posed_scene(work, n_views=n_views)
        print(f"scene: {n_views} views 1280x960 rendered in {time.perf_counter() - t0:.2f} s", flush=True)
        torch.cuda.reset_peak_memory_stats(dev)
        sgm_kernel.launches.update(dict.fromkeys(sgm_kernel.launches, 0))
        res = run_main_path(work, sfm, dev)
        # the 8 maps again at the JAX runner's D = 96, and one map of view 1
        # at D = 320 (10 values a lane, on the width-12 kernel)
        depth96 = os.path.join(work, "depth96")
        t0 = time.perf_counter()
        stages.depth_map_estimation(sfm, res["dense"], depth96, n_depths=96, n_tcams=4,
                                    downscale=2, device=dev)
        torch.cuda.synchronize()
        res["seconds"]["depthMapEstimation_D96"] = time.perf_counter() - t0
        depth320 = os.path.join(work, "depth320")
        t0 = time.perf_counter()
        stages.depth_map_estimation(sfm, res["dense"], depth320, n_depths=320, n_tcams=4,
                                    downscale=2, range_start=0, range_size=1, device=dev)
        torch.cuda.synchronize()
        res["seconds"]["depthMapEstimation_D320_one_view"] = time.perf_counter() - t0
        launches = dict(sgm_kernel.launches)
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        print("stage seconds " + json.dumps(res["seconds"]), flush=True)
        print(f"peak device memory: {peak_gib:.2f} GiB", flush=True)
        print("SGM kernel launches " + json.dumps(launches), flush=True)

        # sgm_aggregate: two sgm_axis_sweeps calls of two launches a map
        expected = {"sgm_directional_pass": 0, "sgm_axis_sweeps": LAUNCHES_PER_MAP * (2 * n_views + 1)}
        if launches != expected:
            raise RuntimeError(f"SGM kernel launched {launches}, expected {expected}")
        maps = (
            [(v, res["depth"], "D=256") for v in range(n_views)]
            + [(v, depth96, "D=96") for v in range(n_views)]
            + [(0, depth320, "D=320")]
        )
        missed = []
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
                missed.append(f"view {v + 1} ({label})")
        if missed:
            raise RuntimeError(f"{', '.join(missed)} miss the depth floors (<0.01, >0.30)")
        with open(res["ply"]) as f:
            header = [next(f) for _ in range(3)]
        n_ply = int(header[2].split()[-1])
        print(f"cloud.ply: {n_ply} points", flush=True)
        if n_ply != res["n_points"] or n_ply <= 5000:
            raise RuntimeError(f"cloud.ply holds {n_ply} points, expected more than 5000")

        # 5. the SfM front end on the same images
        front = check_front(dev, work, os.path.join(work, "images"), sfm, n_views)

        # 6. the whole main path, images to cloud.ply, on the same images
        pipe, pipe_launches = check_pipeline(dev, work, os.path.join(work, "images"), sfm, gt)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 7. the bundle adjuster
    ba_rows = check_ba(dev)

    # 8. results
    print(json.dumps({"front": front}), flush=True)
    print(json.dumps({"pipeline": pipe}), flush=True)
    print(json.dumps({"ba": ba_rows}), flush=True)
    launches = {k: launches[k] + pipe_launches[k] for k in launches}
    print(json.dumps({"kernels": [kernels_line(rows, agg_rows, launches)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
