#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's dense depth-map path with all its branches,
its SfM front end, its whole main path (images to point cloud, from
`.npy` images, from camera JPEGs and from 16-bit camera TIFFs through its
own codecs), keyframe selection from an MJPEG AVI, its
surface mesher, Meshroom's chain through its CLI (images to textured mesh,
one process a stage), the HDR panorama chain and global SfM, the hard scene
(images to poses), camera and rig localization against it, the auxiliary
pipelines (masking, ONNX segmentation, colour harmonization, lidar and
E57), and its bundle adjuster once on one GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit (`nvcc`). It

1. prints the card's name and power limit (nvidia-smi) and turns TF32 off;
2. builds every CUDA source of the port (`alicevision_tpu_torch/csrc/`) and
   its host C++ max-flow, JPEG codec and TIFF / PNG loops
   (`native/maxflow.cpp`, `native/jpeg.cpp`, `native/codecs.cpp`, with g++);
3. holds the SGM kernel's two entries against their plain PyTorch versions
   on the card: `sgm_directional_pass` at the reference's test shapes,
   ragged ones, D past 512 (the carry in shared memory, up to the
   reference's default of 1500 planes) and the stacked (S, N, D) sweeps of
   one 640x480 map at D = 96, 256, 320, 512 and 1500, timed there with CUDA
   events beside the bandwidth bound; then `sgm_axis_sweeps` and the card's
   `sgm_aggregate` (against the same function over the plain sweeps) on
   (D, H, W) volumes at D = 96, 256 and 320 (640x480), two ragged ones,
   one at D = 1500 and the dense_full phase's tiles and maps (1024x1024 at
   D = 128, 384x384 at D = 96, 272x480 at D = 256), with the aggregate's extra device memory (no flipped or
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
5. the `dense_full` phase, on the same scene at the runner's D = 96:
   depthMapEstimation with refine=True (SGM, the two-stage Refine, 20
   colour iterations), depthMapFiltering with normal maps and one SGM map
   with the guided cost filter (radius 4), each view held to the JAX
   package's statistics for the same maps (DENSE_FULL_REFERENCE), and the
   tiled branch (384-px tiles, 64 overlap; every tile off its centre, so
   the gather sweep), each view within one depth step of its untiled map
   at the median; then bench.py's dense points, best of 3 warm calls: SGM
   at 272x480 (D = 256) + the dense (301-hypothesis) or two-stage Refine
   at 544x960 (T = 4) + 100 colour iterations, and sgm_depth_map_tiled on
   a 1920x1088 view (1024-px tiles, 128 overlap, D = 128) held within one
   depth step of the view's untiled map, as maps/s with peak device
   memory; every SGM launch counted, 4 a map and 4 a tile (16 for the
   tiled view);
6. runs the port's SfM front end on the same images (cameraInit ->
   featureExtraction at the runner's 4096 keypoints, resized to 1024x768 ->
   exhaustive imageMatching -> featureMatching with AC-RANSAC F), twice,
   timing the second (warm) run, and checks the keypoints per view, the
   inliers of each adjacent pair, the inliers' Sampson distance to the
   rendered poses' true epipolar geometry, and view 1's features on the
   CPU against the card's;
7. runs the port's `run_full_pipeline` on the same images, twice (cold,
   then warm): cameraInit -> featureExtraction -> imageMatching ->
   featureMatching -> incrementalSfm (tracks, 5-point initial pair, P3P
   resection, triangulation, BA and joint intrinsics BA) ->
   prepareDenseScene -> depthMapEstimation (D = 96) -> depthMapFiltering ->
   meshing, and checks the poses (similarity-aligned to the rendered ones),
   the landmarks, each posed view's depth map, the cloud and the SGM
   launches (four a map); then incrementalSfm once more with its host syncs
   counted; and the focal split: (fx, fy) of the port's CPU front end on
   these views (tests/golden/focal_parting_tracks.npz) and of the card's,
   each through the CPU engine and the card's;
7a. the `photos` phase (after step 7): the port's JPEG codec
   (native/jpeg.cpp, built with g++) on the committed fixtures against
   PIL's hashes and the plain decoder; a 24 MP photograph encoded at
   quality 95 and decoded, timed, with its PSNR; the same 8 views as
   camera JPEGs (FocalLength in the Exif sub-IFD) through
   run_full_pipeline with no default focal, held to the pipeline's gates
   and 32 SGM launches; tests/test_pipeline_photos.py's 40 distorted
   640x480 views rendered on the card, through cameraInit from EXIF,
   DSP-SIFT, voctree pairs, matching and incrementalSfm at its gates;
7a'. the `codecs` phase (after step 7a): the port's TIFF, BMP, PNG and
   MJPEG AVI readers (native/codecs.cpp, built with g++) on the committed
   fixtures against the JAX package's recorded reading (C++ and plain); a
   24 MP 16-bit RGB TIFF as LZW (the committed strip, replicated) and as
   deflate, and a 24 MP BMP, timed; the same 8 views as 16-bit camera
   TIFFs (the focal in IFD0 or the Exif sub-IFD) through run_full_pipeline
   with no default focal, 32 SGM launches; a 1920x1080 MJPEG AVI of 60
   frames through keyframeSelection --method smart, equal to the same
   command on its frames as .npy; its full row in
   chiprun_out/codecs_phase.json;
7b. the `cli` phase (after step 7): Meshroom's chain on the same images as
   14 processes of `python -m alicevision_tpu_torch.pipeline.cli`, one a
   stage, at the CLI's defaults, each timed from launch to exit with the
   stage's own seconds, its host peak (resident memory sampled from /proc
   every 10 ms) and its device peak: cameraInit -> featureExtraction ->
   imageMatching -> featureMatching -> incrementalSfm -> prepareDenseScene
   -> depthMapEstimation (D = 96) -> depthMapFiltering -> meshSurface ->
   meshFiltering (--clean --fillHolesMaxEdges 8) -> texturing (2048^2,
   multi-band, with --depth), then tracksBuilding -> sfmBootstraping ->
   sfmExpanding on the same features and matches; depthMapEstimation once
   more in this process through `cli.main` (4 SGM launches a map, the maps
   equal to the subprocess's); checked are the poses (the pipeline phase's
   gates, rotations held to the reference's spread on this chain's
   features), the D = 96 maps (its depth floors), the surface mesh (the
   mesh_surface size and index gates; mapped into the rendered frame by
   the centres' similarity, its box-world numbers held to the JAX chain's
   on the same features with a margin; within 2 % of the maps it was fused
   from in every view), the filtered mesh (valid, no degenerate face), the
   textured OBJ (vt and usemtl lines, an atlas filled over 3.5 %, read back
   by the port's own PNG reader) and sfmExpanding's poses;
7c. the `panorama` phase (after step 7b), in this process through
   `cli.main`: a procedural HDR equirect radiance (2048x1024, fixed seed)
   split on the card into 12 views of 1024^2 (fov 80 deg, 30 deg apart),
   3 Laguerre brackets a view (exposures 1, 4, 16), then ldrToHdrSampling
   and ldrToHdrCalibration by the three methods on view 0, ldrToHdrMerge of
   each view (Laguerre), cameraInit -> featureExtraction -> imageMatching
   -> featureMatching at the CLI's defaults, panoramaEstimation and
   nodalSfM (equal scenes), panoramaEstimation again on the ring's
   sequential pairs, panoramaWarping (2048) -> panoramaSeams ->
   panoramaMerging --seams -> panoramaCompositing -> panoramaPostProcessing
   --fillHoles --crop, panoramaPrepareImages, panoramaInit, split360Images
   (held to split_equirect within 8-bit quantisation) and imageProcessing;
   the warp and composite of the 12 merged views at 8192 with both blur
   forms timed; relativePoseEstimating -> globalSfM on the cli phase's 8
   views. Gated: Laguerre phi, the merged radiance's correlation with the
   truth, the rotation errors, the panoramas' median errors, globalSfM's
   rotations and ATE (the JAX chain's readings with a margin,
   scripts/panorama_chain_reference.py), and no SGM launch;
8. runs the bundle adjuster (`sfm/ba.py`) at the two problem sizes of
   bench.py — 100 cameras / 10k landmarks through the dense Schur solve and
   1024 cameras / 300k landmarks through matrix-free PCG — timing LM
   iterations per second and checking convergence, then solves a mid-size
   problem on the CPU and on the card and holds the two results together;
9. the `mesh_surface` phase (after step 4): depthMapFiltering of the D = 96
   maps and `meshing_surface` (fusion on the card, Delaunay, the
   visibility graph cut in the port's C++ max-flow, the largest component,
   a Taubin smooth on the card, OBJ), checking the mesh's size, indices and
   distance to the box world, with its seconds by step;
10. the `hard_scene` phase (after step 7): the engine on the 40-view
   ground-truth-projection matches of `hard_scene` at the normal and the
   stressed prior (tests/test_hard_scene.py's gates and golden file), then
   bench.py's images path at the reference's operating point: 40 distorted
   1280x960 views rendered on the card (two held against the host numpy
   render), DSP-SIFT at 10,000 keypoints,
   voctree pairs, matching and incrementalSfm (at least 39 of 40 posed,
   ATE < 1.2 % of the radius), with stage seconds, peak memory and the
   engine's seconds by step;
10b. the `localization` phase (after step 10, on its reconstruction, with
   feature ids recovered by position): 8 query views rendered on the card
   midway between ring neighbours, and a second rig camera's (15 deg of
   yaw, 0.25 to the side), through `cli.main`: cameraLocalization
   (voctree and direct, at the CLI's defaults, at full resolution, on
   the queries' 1024x768 windows, which the defaults do not decimate, and
   on renders at 2560x1920 against the reconstruction's intrinsics scaled
   x2; the draw-dependent runs repeated for 8 seeds in the process),
   rigCalibration on posed rig scenes, rigTransform, sfmToRig,
   rigLocalization (joint; average on the windows),
   frustumFiltering on the 40-view truth (against the CPU's pairs), the
   scene tools (split -> merge gives the scene back, sfmRegression of it
   against itself, sfmTransfer, applyCalibration, sfmDistances,
   generateSampleScene); resection_dlt6, EPnP, P4Pf and P5Pfr on 4096
   samples of the hard scene's truth, timed, against the CPU on 512 of
   them; a tag16h5 marker sequence through featureExtraction's marker
   branch, localize_by_markers and refine_sequence. Gated by the JAX
   chain's readings on the same inputs (LOC_GATES); no SGM launch;
10c. the `solvers` step: the main path's null-vector solvers (5-point, F,
   H, both triangulations, the quaternion average, the rotation graph) on
   4096 samples of the hard scene's truth, the card against the CPU, and a
   batched eigh past cuSOLVER's batch limit;
10d. the `calibration` phase: a 15-frame 1920x1080 board shoot, a Macbeth
   chart and a 12-light 2048x1536 photometric shoot (numpy, seeded) through
   the 13 calibration, distortion, chart and photometric subcommands in
   this process, gated on the truth at the JAX chain's readings
   (CAL_GATES), Zhang's K and the normals held to the CPU; no SGM launch;
10e. the `extras` phase: AKAZE and AKAZE-MLDB extraction and F-filtered
   matching, the homography-growing filter and K-VLD / the photometric
   filter on the dense scene's views and the `cli` phase's features,
   keyframeSelection on a rendered sequence, and the eleven subcommands of
   ROADMAP item 13 (a) on the `cli` phase's outputs, on the card and on the
   CPU (byte-equal files), gated at the JAX package's readings on the same
   images (EXTRAS_REFERENCE); no SGM launch;
10f. the `aux` phase: the seven subcommands of ROADMAP item 13 (d) on the
   card and on the CPU: imageMasking over the dense scene's 8 views (HSV
   and Otsu) and a 24 MP photograph (HSV, grown and shrunk by 2),
   imageSegmentation of a 12 MP photograph by the classical sky scorer and
   by a network with torchvision's fcn_resnet50 layout (random seeded
   weights, 63 tiles of 512 px) through the port's ONNX executor, two of
   its tiles card against CPU in this process, sfmColorHarmonize of the cli
   phase's views under known gains and offsets, and importE57 ->
   lidarMerging -> lidarDecimating -> lidarMeshing on three ray-cast
   scanner stations of 1024x512 rays (masks bit-equal and lidar files
   byte-equal across devices), gated at the JAX chain's readings on the
   same inputs (AUX_REFERENCE); no SGM launch;
10g. the `scaleout` phase: an nccl process group of one rank on a free
   local port, joined through the port's `distributed.join_group` (one
   card: no scaling can be measured), the port's counted all_reduce,
   all_gather and gather on card tensors over it, then the
   landmark-sharded BA (dense and PCG) on the mid-size problem held to
   `ba_solve` on the card, make_sharded_sgm on the dense scene's 8 views at
   D = 96 equal to the unsharded `batched_sgm` (4 SGM launches a map), the
   ring-halo consistency filter bit-exact with `consistency_filter_ring`,
   and the BA and fusion comms tables at one shard (0 collective bytes);
11. prints a `mesh_surface`, a `hard_scene`, a `dense_full`, a `front`, a
   `pipeline`, a `photos`, a `codecs`, a `ba`, a `cli`, a `panorama`, a `localization`, a
   `solvers`, a `calibration`, an `extras`, an `aux`, a `scaleout` and a
   `kernels` JSON line, the whole run's seconds and, last,
   `{"ok": true, "device": ...}`.

Every failed check raises, so the script exits non-zero and prints no result.
It needs a CUDA device; `make_posed_scene`, `run_main_path`, `run_front`,
`front_report`, `run_pipeline`, `pipeline_report`, `run_mesh_surface`,
`cli_chain`, `check_cli`, `make_panorama_inputs`, `run_panorama_chain`,
`panorama_report`, `run_hard_scene_engine`, `run_hard_images`,
`run_localization_phase`, `check_eigh_sites`, `run_calibration_phase`,
`run_extras_phase`, `run_aux_phase`, `run_photos_phase`, `run_codecs_phase`,
the bench scenes and the BA problem builders
also run on the CPU at small sizes (the port's tests call some of them
so).
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import warnings
import zlib

import numpy as np
import torch

from alicevision_tpu_torch import camera as cam
from alicevision_tpu_torch import native, sfmdata
from alicevision_tpu_torch.geometry import mat_to_quat, quat_to_mat, so3_exp
from alicevision_tpu_torch.mvs import plane_sweep
from alicevision_tpu_torch.mvs.plane_sweep import _axis_sweeps, _directional_pass
from alicevision_tpu_torch.ops import build, sgm_kernel
from alicevision_tpu_torch.features import sift
from alicevision_tpu_torch.image import exif, jpeg
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
# volumes, D = 1500, and the maps of the dense_full phase: a 1024-px tile
# of bench.py's tiled point (D = 128), a 384-px tile of the tiled stage
# (D = 96) and bench.py's 272x480 SGM map before Refine (D = 256).
AGG_TIMED = [(96, 480, 640), (256, 480, 640), (320, 480, 640)]
AGG_SHAPES = AGG_TIMED + [(131, 37, 53), (3, 29, 41), (1500, 48, 64),
                          (128, 1024, 1024), (96, 384, 384), (256, 272, 480)]
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


# ------------------------------------------------------------ dense_full

# Checks of the dense_full phase, on the dense phase's 8 views with
# ground-truth poses at the runner's D = 96. The plain, refined and guided
# maps are held to the JAX package's maps of the same scene, made on the
# CPU by scripts/dense_full_reference.py: each view's median relative
# error against the rendered depth within REF_MED_RTOL (+ REF_MED_ATOL) of
# the JAX package's, its valid fraction within REF_VALID_ATOL. The guided
# map, and each refined view whose JAX map meets them, must also meet
# tests/test_golden_mvs.py's floors (DENSE_MED, DENSE_VALID); the JAX
# package's refined view 1 (0.0107) does not, and is listed in the row as
# waived. Refine at its defaults raises the median error of every view
# over the plain D = 96 map in the reference itself (JAX: 0.0107 against
# 0.0061 on view 1), so that is reported and not required. The tiled maps
# are held to the untiled D = 96 maps of the same views (the JAX
# package's plain maps meet the floors on every view): within
# TILED_MAX_STEPS depth steps at the median, and the floors. The port
# sends every tile of a map of more than one tile to the gather sweep,
# where the JAX package's pose gate takes the rectified sweep, which
# misses off the image's centre (its tiled view 8 at 0.254). What is
# required besides: normals of unit length facing the camera, and tiled
# disagreements no denser at the tile seams than elsewhere
# (tests/test_tiled_stage.py).
REF_MED_RTOL, REF_MED_ATOL, REF_VALID_ATOL = 0.1, 3e-4, 0.005
DENSE_FULL_REFERENCE = {  # scripts/dense_full_reference.py, [median, valid] a view
    "plain": [
        (0.00611369, 0.365319), (0.0048485, 0.372585), (0.00173855, 0.377624),
        (0.00155534, 0.380322), (0.00164962, 0.380667), (0.00180561, 0.3789),
        (0.00462088, 0.37542), (0.00617725, 0.370426),
    ],
    "refine": [
        (0.0106586, 0.365319), (0.0076453, 0.372585), (0.00207669, 0.377624),
        (0.00190238, 0.380322), (0.0021093, 0.380667), (0.00198223, 0.3789),
        (0.00697859, 0.37542), (0.00960695, 0.370426),
    ],
    "guided_view1": (0.00496804, 0.365319),
}
DENSE_MED, DENSE_VALID = 0.01, 0.30
NORMAL_UNIT_ATOL, NORMAL_FACING_FRAC = 1e-3, 0.95
TILE_SIZE, TILE_OVERLAP = 384, 64  # four clamped 384x384 tiles of a 640x480 map
TILED_MAX_STEPS = 1.0  # a tiled map's median distance from the untiled map, in depth steps
GUIDED_RADIUS = 4
# bench.py's dense operating points (bench_depth_maps): SGM at 272x480,
# D = 256, then Refine at 544x960, T = 4, 100 colour iterations; the tiled
# point is a 1920x1088 view in 1024-px tiles, 128 overlap, D = 128, T = 4
BENCH_T = 4
BENCH_D_RANGE = (3.0, 10.0)
BENCH_REFINE = {
    "sgm_refine_depth_maps_per_s": dict(n_offsets=150, rel_step=0.0005, n_subsamples=1),
    "sgm_refine_fast_two_stage_maps_per_s": dict(n_offsets=15, n_subsamples=10),
}
BENCH_TILED = dict(wh=(1920, 1088), focal_px=1800.0, tile=1024, overlap=128, n_depths=128)
# bench.py checks only the shape; here the refined maps must also be finite
# with a median error below 5 % (a sanity bound: the JAX package's maps of
# this size are not computed on the CPU), the tiled map finite with its
# reference view's coverage and within TILED_MAX_STEPS depth steps of the
# view's untiled map at the median (its four 1024-px tiles take the gather
# sweep)
BENCH_SANE_MED = 0.05


def bench_refine_scene(device, wh=(960, 544), focal_px: float = 900.0):
    """bench.py's SGM + Refine scene: 5 rendered views on a 0.35 rad arc,
    view 0 the reference and 1-4 its T-cams; the SGM inputs at half
    resolution, the Refine inputs at full, and the host dispatch plan of
    the refine (the same for the dense and the two-stage grids)."""
    from alicevision_tpu_torch.mvs.refine import refine_plan

    W, H = wh
    imgs, gt, K, R, c = render_views(n_views=BENCH_T + 1, wh=wh, focal_px=focal_px, arc=0.35)
    R_rel = np.stack([R[t] @ R[0].T for t in range(1, BENCH_T + 1)])
    t_rel = np.stack([R[t] @ (c[0] - c[t]) for t in range(1, BENCH_T + 1)])
    K_s = K.copy()
    K_s[:2] /= 2.0

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)

    return {
        "ref_r": t(imgs[0]), "t_r": t(imgs[1:]), "ref_s": t(imgs[0, ::2, ::2]), "t_s": t(imgs[1:, ::2, ::2]),
        "K_r": t(K), "Kt_r": t(np.broadcast_to(K, (BENCH_T, 3, 3))),
        "K_s": t(K_s), "Kt_s": t(np.broadcast_to(K_s, (BENCH_T, 3, 3))),
        "R_rel": t(R_rel), "t_rel": t(t_rel), "gt": gt[0],
        "plan": refine_plan(K, np.broadcast_to(K, (BENCH_T, 3, 3)), R_rel, t_rel, BENCH_D_RANGE, (H, W)),
    }


def sgm_refine_view(sc: dict, refine_kw: dict, n_depths: int = 256, color_iters: int = 100):
    """One view of bench.py's point: SGM at half resolution, the map
    upsampled 2x, Refine with `refine_kw`, then the colour optimisation."""
    from alicevision_tpu_torch.mvs.refine import color_guided_optimize, refine_depth_map_auto

    depth, _ = plane_sweep.sgm_depth_map(
        sc["ref_s"], sc["t_s"], sc["K_s"], sc["Kt_s"], sc["R_rel"], sc["t_rel"],
        *BENCH_D_RANGE, plane_sweep.SgmParams(n_depths=n_depths),
    )
    up = depth.repeat_interleave(2, 0).repeat_interleave(2, 1)
    d2, s2 = refine_depth_map_auto(
        up, sc["ref_r"], sc["t_r"], sc["K_r"], sc["Kt_r"], sc["R_rel"], sc["t_rel"],
        plan=sc["plan"], **refine_kw,
    )
    return color_guided_optimize(d2, sc["ref_r"], iterations=color_iters), s2


def bench_tiled_scene(device, wh=BENCH_TILED["wh"], focal_px: float = BENCH_TILED["focal_px"]):
    """bench.py's tiled point: view 0 of 5 rendered views and its 4 T-cams."""
    imgs, gt, K, R, c = render_views(n_views=BENCH_T + 1, wh=wh, focal_px=focal_px, arc=0.35)
    R_rel = np.stack([R[t] @ R[0].T for t in range(1, BENCH_T + 1)]).astype(np.float32)
    t_rel = np.stack([R[t] @ (c[0] - c[t]) for t in range(1, BENCH_T + 1)]).astype(np.float32)
    K = K.astype(np.float32)
    return {"args": (imgs[0], imgs[1:], K, np.tile(K[None], (BENCH_T, 1, 1)), R_rel, t_rel,
                     *BENCH_D_RANGE), "gt": gt[0]}


def _best_of(fn, reps: int = 3):
    """fn() once to warm up, then `reps` more calls, each with the SGM
    launch counts set to 0 just before it, read just after, and ending in
    a synchronize. Returns (the best wall seconds of the timed calls, each
    call's launches, the last result)."""
    best, per_call, out = math.inf, [], None
    for i in range(reps + 1):
        torch.cuda.synchronize()
        sgm_kernel.launches.update(dict.fromkeys(sgm_kernel.launches, 0))
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        if i:
            best = min(best, time.perf_counter() - t0)
        per_call.append(dict(sgm_kernel.launches))
    return best, per_call, out


def bench_tiled_point(dev) -> dict:
    """bench.py's tiled point on the card: the untiled map of its view (one
    call, its seconds and SGM launches), then sgm_depth_map_tiled timed by
    `_best_of` with its peak device memory; both maps' median relative
    error against the rendered depth, and the tiled map's median distance
    from the untiled map in depth steps (`tiled_seam_stats`)."""
    from alicevision_tpu_torch.mvs.sharded import make_tiles, sgm_depth_map_tiled

    cfg = BENCH_TILED
    sc = bench_tiled_scene(dev)
    params = plane_sweep.SgmParams(n_depths=cfg["n_depths"])
    torch.cuda.synchronize()
    sgm_kernel.launches.update(dict.fromkeys(sgm_kernel.launches, 0))
    t0 = time.perf_counter()
    untiled, _ = plane_sweep.sgm_depth_map(
        *(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in sc["args"][:6]), *sc["args"][6:], params)
    torch.cuda.synchronize()
    untiled_s, untiled_launches = time.perf_counter() - t0, dict(sgm_kernel.launches)
    untiled = untiled.cpu().numpy()
    torch.cuda.reset_peak_memory_stats(dev)
    sec, calls, d = _best_of(lambda: sgm_depth_map_tiled(
        *sc["args"], params, tile=cfg["tile"], overlap=cfg["overlap"], device=dev))
    d = d.cpu().numpy()
    W, H = cfg["wh"]
    rois = make_tiles(H, W, cfg["tile"], cfg["overlap"], clamp=True)
    med, frac = depth_stats(d, sc["gt"])
    return {"maps_per_s": 1.0 / sec, "seconds": sec, "tiles": len(rois), "sgm_launches_per_call": calls,
            "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "shape": list(d.shape), "finite": bool(np.isfinite(d).all()), "median_rel_err": med,
            "valid_frac": frac, "untiled_seconds": untiled_s, "untiled_sgm_launches": untiled_launches,
            "untiled_median_rel_err": depth_stats(untiled, sc["gt"])[0],
            "median_steps_from_untiled": tiled_seam_stats(d, untiled, sc["gt"], cfg["n_depths"], rois)["median_steps"]}


def _view_inputs(sfm: str, dense: str, v: int, n_depths: int, dev, n_tcams: int = 4, downscale: int = 2):
    """The SGM inputs of view index v as depthMapEstimation builds them: the
    nearest posed T-cams, relative poses and the SfM-seeded depth list."""
    from alicevision_tpu_torch.mvs.depth_list import sgm_depth_list
    from alicevision_tpu_torch.mvs.fusion import depth_range_from_landmarks

    sc = sfmdata.load(sfm)
    valid = list(sc.valid_views())
    K, R, c, img = {}, {}, {}, {}
    for u in valid:
        K[u] = stages._K(sc, int(sc.view_intrinsic[u]), downscale)
        R[u] = sc.pose_R[int(sc.view_pose[u])].astype(np.float32)
        c[u] = sc.pose_c[int(sc.view_pose[u])].astype(np.float32)
        img[u] = np.load(os.path.join(dense, f"{int(sc.view_ids[u])}.npy"))[::downscale, ::downscale]
    d = np.linalg.norm(np.stack([c[u] for u in valid]) - c[v], axis=1)
    order = [valid[i] for i in np.argsort(d) if valid[i] != v][:n_tcams]
    hw = {u: (img[u].shape[1], img[u].shape[0]) for u in valid}
    dl = sgm_depth_list(sc.points, sc.obs_landmark, sc.obs_view, sc.obs_uv, v, R, c, K, hw, order, n_depths,
                        fallback_range=depth_range_from_landmarks(sc.points, R[v], c[v]))

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    return (
        (t(img[v]), t(np.stack([img[u] for u in order])), t(K[v]), t(np.stack([K[u] for u in order])),
         t(np.stack([R[u] @ R[v].T for u in order])), t(np.stack([R[u] @ (c[v] - c[u]) for u in order])),
         dl.d_min, dl.d_max),
        dict(depths=dl.depths, tc_depth_ranges=t(stages._tc_ranges(dl, n_depths))),
    )


def tiled_seam_stats(tiled: np.ndarray, full: np.ndarray, gt: np.ndarray, n_depths: int, rois) -> dict:
    """tests/test_tiled_stage.py's comparison, on the pixels where the
    rendered scene has a surface (gt > 0; the background's depths are
    arbitrary in both maps): the median |tiled - full| in depth steps of an
    n_depths inverse grid over the full map's range, and the share of
    pixels more than 1.5 steps apart in a 4-px band around the interior
    tile borders against the share over the map."""
    valid = (full > 0) & (tiled > 0) & (gt > 0)
    inv_span = abs(1.0 / max(full[valid].min(), 1e-3) - 1.0 / full[valid].max())
    step = full**2 * (inv_span / (n_depths - 1))
    steps = np.abs(tiled - full) / step
    big = (steps > 1.5) & valid
    band = np.zeros_like(big)
    H, W = full.shape
    for (y0, y1, x0, x1) in rois:
        for y in (y0, y1):
            if 0 < y < H:
                band[max(y - 4, 0):y + 4, :] = True
        for x in (x0, x1):
            if 0 < x < W:
                band[:, max(x - 4, 0):x + 4] = True
    return {
        "valid_frac": float(valid.mean()),
        "median_steps": float(np.median(steps[valid])),
        "seam_band_frac": float(big[band & valid].mean()),
        "global_frac": float(big[valid].mean()),
    }


def check_dense_full(dev, work: str, sfm: str, gt: np.ndarray, dense: str, depth96: str, n_views: int,
                     card: str) -> tuple:
    """The dense_full phase: depthMapEstimation with refine at D = 96,
    depthMapFiltering with normal maps, the tiled branch, one guided SGM map,
    and bench.py's three dense points timed warm beside `card` (nvidia-smi's
    name and power limit), with every SGM launch counted (4 a map, 4 a
    tile). Returns (the `dense_full` row, launches)."""
    from alicevision_tpu_torch.image.io import read_image
    from alicevision_tpu_torch.mvs.sharded import make_tiles

    t_phase = time.perf_counter()
    row, bad, total = {"seconds": {}}, [], dict.fromkeys(sgm_kernel.launches, 0)

    def count(calls):
        for got in calls:
            for k in total:
                total[k] += got[k]

    def stage(name, want_launches, fn, *args, **kw):
        torch.cuda.synchronize()
        sgm_kernel.launches.update(dict.fromkeys(sgm_kernel.launches, 0))
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        row["seconds"][name] = time.perf_counter() - t0
        got = dict(sgm_kernel.launches)
        count([got])
        if got != {"sgm_directional_pass": 0, "sgm_axis_sweeps": want_launches}:
            bad.append(f"{name}: SGM launches {got}, expected {want_launches} through sgm_axis_sweeps")
        return out

    torch.cuda.reset_peak_memory_stats(dev)
    # Refine through the stage, at the runner's D = 96
    refined = os.path.join(work, "depth96_refined")
    stage("depthMapEstimation_D96_refine", LAUNCHES_PER_MAP * n_views, stages.depth_map_estimation,
          sfm, dense, refined, n_depths=96, refine=True, device=dev)
    ref = DENSE_FULL_REFERENCE

    def held(name, stats, want):
        """A map's [median, valid] against the JAX package's."""
        (m, f), (m_j, f_j) = stats, want
        if not (abs(m - m_j) <= REF_MED_RTOL * m_j + REF_MED_ATOL and abs(f - f_j) <= REF_VALID_ATOL):
            bad.append(f"{name}: median {m:.5f}, valid {f:.4f}; the JAX package's {m_j:.5f}, {f_j:.4f}")

    def meets(stats):
        return stats[0] < DENSE_MED and stats[1] > DENSE_VALID

    def floors(name, stats, want, waived):
        """tests/test_golden_mvs.py's floors, on every view where the JAX
        package's map meets them; the other views are listed in `waived`."""
        if not meets(want):
            waived.append(name)
        elif not meets(stats):
            bad.append(f"{name}: median {stats[0]:.5f}, valid {stats[1]:.4f}, under the golden floors")

    def view_stats(folder, v):
        d = np.load(os.path.join(folder, f"{v + 1}_depth.npy"))
        gt_v = gt[v, ::2, ::2]
        if d.shape != gt_v.shape or not np.isfinite(d).all():
            bad.append(f"{folder} view {v + 1}: {d.shape} not finite or not {gt_v.shape}")
        return depth_stats(d, gt_v)

    stats_r = [view_stats(refined, v) for v in range(n_views)]
    stats_p = [view_stats(depth96, v) for v in range(n_views)]
    waived = []
    for v in range(n_views):
        held(f"D = 96 view {v + 1}", stats_p[v], ref["plain"][v])
        held(f"refined view {v + 1}", stats_r[v], ref["refine"][v])
        floors(f"refined view {v + 1}", stats_r[v], ref["refine"][v], waived)
    row["refine"] = {
        "median_rel_err": [m for m, _ in stats_r],
        "unrefined_median_rel_err": [m for m, _ in stats_p],
        "jax_median_rel_err": [m for m, _ in ref["refine"]],
        "views_not_worse": sum(r[0] <= p[0] for r, p in zip(stats_r, stats_p)),
    }

    # normal maps of the filtered refined maps
    filtered = os.path.join(work, "filtered_refined")
    stage("depthMapFiltering_normals", 0, stages.depth_map_filtering, sfm, refined, filtered,
          min_consistent=2, compute_normal_maps=True, device=dev)
    sc = sfmdata.load(sfm)
    K = stages._K(sc, 0, 2, np.float64)
    unit_err, facing = 0.0, []
    for v in range(n_views):
        n = read_image(os.path.join(filtered, f"{v + 1}_normalMap.exr"))
        ok = (n != -1).any(-1)
        ys, xs = np.nonzero(ok)
        ray = np.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones(len(xs))], -1)
        unit_err = max(unit_err, float(np.abs(np.linalg.norm(n[ok], axis=-1) - 1).max(initial=0.0)))
        facing.append(float((np.sum(n[ok] * ray, -1) < 0).mean()) if ok.any() else 0.0)
    row["normals"] = {"max_unit_err": unit_err, "facing_frac": facing}
    if unit_err > NORMAL_UNIT_ATOL or min(facing) <= NORMAL_FACING_FRAC:
        bad.append(f"normals: unit length within {unit_err}, facing the camera {facing}")

    # the tiled branch against the untiled D = 96 maps
    tiled = os.path.join(work, "depth96_tiled")
    rois = make_tiles(gt.shape[1] // 2, gt.shape[2] // 2, TILE_SIZE, TILE_OVERLAP, clamp=True)
    stage("depthMapEstimation_D96_tiled", LAUNCHES_PER_MAP * len(rois) * n_views, stages.depth_map_estimation,
          sfm, dense, tiled, n_depths=96, tile_size=TILE_SIZE, tile_overlap=TILE_OVERLAP, device=dev)
    seams = []
    for v in range(n_views):
        st = tiled_seam_stats(np.load(os.path.join(tiled, f"{v + 1}_depth.npy")),
                              np.load(os.path.join(depth96, f"{v + 1}_depth.npy")), gt[v, ::2, ::2], 96, rois)
        stats = view_stats(tiled, v)
        st["median_rel_err"], st["untiled_median_rel_err"] = stats[0], stats_p[v][0]
        seams.append(st)
        floors(f"tiled view {v + 1}", stats, ref["plain"][v], waived)
        if not st["median_steps"] < TILED_MAX_STEPS:
            bad.append(f"tiled view {v + 1}: {st['median_steps']:.3f} depth steps from the untiled map at the "
                       f"median, expected below {TILED_MAX_STEPS}")
        if not st["seam_band_frac"] < 2.0 * st["global_frac"] + 0.05:
            bad.append(f"tiled view {v + 1}: disagreements gather at the seams, {st}")
    row["tiled"] = {"tiles_per_map": len(rois), "views": seams}
    row["golden_floors_waived"] = waived

    # one guided-filtered SGM map
    args, kw = _view_inputs(sfm, dense, 0, 96, dev)
    d_g, _ = stage("sgm_depth_map_guided", LAUNCHES_PER_MAP, plane_sweep.sgm_depth_map, *args,
                   plane_sweep.SgmParams(n_depths=96, guided_radius=GUIDED_RADIUS), **kw)
    m_g, f_g = depth_stats(d_g.cpu().numpy(), gt[0, ::2, ::2])
    row["guided"] = {"radius": GUIDED_RADIUS, "median_rel_err": m_g, "valid_frac": f_g,
                     "jax_median_rel_err": ref["guided_view1"][0]}
    held("guided map", (m_g, f_g), ref["guided_view1"])
    if not (m_g < DENSE_MED and f_g > DENSE_VALID):
        bad.append(f"guided map: median {m_g:.5f}, valid {f_g:.3f}")
    row["stage_peak_device_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30

    # bench.py's operating points, warm, best of 3
    bench = {"card": card}
    sc_r = bench_refine_scene(dev)
    for key, kw in BENCH_REFINE.items():
        torch.cuda.reset_peak_memory_stats(dev)
        sec, calls, (d3, _) = _best_of(lambda: sgm_refine_view(sc_r, kw))
        med, frac = depth_stats(d3.cpu().numpy(), sc_r["gt"])
        bench[key] = {"maps_per_s": 1.0 / sec, "seconds": sec, "sgm_launches_per_call": calls,
                      "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                      "median_rel_err": med, "valid_frac": frac}
        count(calls)
        if any(c != {"sgm_directional_pass": 0, "sgm_axis_sweeps": LAUNCHES_PER_MAP} for c in calls):
            bad.append(f"{key}: SGM launches {calls}, expected {LAUNCHES_PER_MAP} a map")
        if not (np.isfinite(d3.cpu().numpy()).all() and med < BENCH_SANE_MED and frac > DENSE_VALID):
            bad.append(f"{key}: median {med:.5f}, valid {frac:.3f}")
    del sc_r
    tiled = bench["sgm_tiled_1920x1088_maps_per_s"] = bench_tiled_point(dev)
    row["seconds"]["sgm_bench_tiled_view_untiled"] = tiled["untiled_seconds"]
    count([tiled["untiled_sgm_launches"]] + tiled["sgm_launches_per_call"])
    if tiled["untiled_sgm_launches"] != {"sgm_directional_pass": 0, "sgm_axis_sweeps": LAUNCHES_PER_MAP}:
        bad.append(f"tiled bench point's untiled map: SGM launches {tiled['untiled_sgm_launches']}, "
                   f"expected {LAUNCHES_PER_MAP}")
    want = {"sgm_directional_pass": 0, "sgm_axis_sweeps": LAUNCHES_PER_MAP * tiled["tiles"]}
    if any(c != want for c in tiled["sgm_launches_per_call"]):
        bad.append(f"tiled bench point: SGM launches {tiled['sgm_launches_per_call']}, expected "
                   f"{LAUNCHES_PER_MAP} a tile")
    if tiled["shape"] != list(BENCH_TILED["wh"][::-1]) or not (tiled["finite"] and tiled["valid_frac"] > DENSE_VALID):
        bad.append(f"tiled bench point: {tiled['shape']}, finite {tiled['finite']}, median "
                   f"{tiled['median_rel_err']:.5f}, valid {tiled['valid_frac']:.3f}")
    if not tiled["median_steps_from_untiled"] < TILED_MAX_STEPS:
        bad.append(f"tiled bench point: {tiled['median_steps_from_untiled']:.3f} depth steps from the untiled map "
                   f"at the median, expected below {TILED_MAX_STEPS}")
    row["bench"] = bench
    row["sgm_launches"] = total
    row["phase_seconds"] = time.perf_counter() - t_phase
    print("dense_full " + json.dumps(row), flush=True)
    if bad:
        raise RuntimeError("dense_full: " + "; ".join(bad))
    return row, total


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
    st = epipolar_stats(posed_sfm, feats, stages.load_matches(res["matches"]))
    return {
        "keypoints_per_view": [int(f["valid"].sum()) for f in feats],
        "inliers_per_pair": st["per_pair"],
        "adjacent_inliers": [st["per_pair"].get(f"{v}_{v + 1}", 0) for v in range(n_views - 1)],
        "inliers_total": st["matches"],
        "frac_within_2px_of_true_epipolar": st["frac_within_2px"],
        "median_sampson_px": st["median_sampson_px"],
    }


def epipolar_stats(posed_sfm: str, feats: list, matches: dict) -> dict:
    """Matches per pair and their Sampson distances to the true epipolar
    geometry: the count, the median and the share within FRONT_EPI_PX."""
    dists, per_pair = [], {}
    for (i, j), pm in sorted(matches.items()):
        per_pair[f"{i}_{j}"] = len(pm)
        if len(pm):
            dists.append(epipolar_px(fundamental_true(posed_sfm, i, j), feats[i]["xy"][pm[:, 0]],
                                     feats[j]["xy"][pm[:, 1]]))
    d = np.concatenate(dists) if dists else np.zeros(0)
    return {"matches": int(len(d)), "per_pair": per_pair,
            "median_sampson_px": float(np.median(d)) if len(d) else None,
            "frac_within_2px": float((d < FRONT_EPI_PX).mean()) if len(d) else 0.0}


def card_cpu_features(img: np.ndarray, dev, extract, downscale_to: int = 1024) -> tuple:
    """`extract` (a describer of a (H, W) tensor) of one image on the CPU
    and on `dev`, resized first as featureExtraction resizes it: two dicts
    of host arrays (xy, scale, orientation, desc, valid)."""
    s = downscale_to / max(img.shape) if max(img.shape) > downscale_to else 1.0
    size = (int(img.shape[1] * s), int(img.shape[0] * s))
    out = []
    for d in ("cpu", dev):
        x = torch.from_numpy(img).to(d)
        f = extract(_resize_bilinear(x, size) if s != 1.0 else x)
        out.append({k: getattr(f, k).cpu().numpy() for k in ("xy", "scale", "orientation", "desc", "valid")})
    return tuple(out)


def compare_cpu_card(img: np.ndarray, dev, downscale_to: int = 1024) -> dict:
    """One view extracted on the CPU and on the card from the same image,
    resized as featureExtraction resizes it: the share of the CPU's valid
    keypoints with a card keypoint within FRONT_CPU_CARD_PX at the same
    orientation, and the largest descriptor difference among those."""
    cfg = sift.SiftConfig(max_keypoints=FRONT_MAX_KEYPOINTS, n_octaves=4)
    a, b = card_cpu_features(img, dev, lambda x: sift.extract(x, cfg), downscale_to)
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


def _angle_deg(A: np.ndarray) -> float:
    """The angle of rotation A in degrees, from its skew and its trace part
    (the trace alone loses angles under ~0.05 deg to float32 rounding)."""
    skew = np.array([A[2, 1] - A[1, 2], A[0, 2] - A[2, 0], A[1, 0] - A[0, 1]])
    return float(np.degrees(np.arctan2(0.5 * np.linalg.norm(skew), 0.5 * (np.trace(A) - 1))))


def rotation_errors_deg(est_R: np.ndarray, R_true: np.ndarray) -> tuple:
    """Each estimated rotation's angle to the truth after the rotation Ro
    that best aligns the orientations (their chordal mean; centres on a
    short arc pin a tilt about its chord only weakly). Returns (angles in
    degrees, Ro)."""
    U, _, Vt = np.linalg.svd(np.einsum("vji,vjk->ik", R_true, est_R))
    Ro = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    return [_angle_deg(Re @ Ro.T @ Rt.T) for Re, Rt in zip(est_R, R_true)], Ro


def pipeline_report(work: str, R_true: np.ndarray, c_true: np.ndarray, gt: np.ndarray, downscale: int = 2) -> dict:
    """The reconstruction in `work` against the rendered truth (view v is
    image v + 1): posed views, camera-centre ATE after a similarity
    alignment of the centres, rotation errors after the rotation that best
    aligns the orientations, each posed view's depth map
    scaled by the alignment's s against the rendered depth, landmarks,
    the refined focal and the cloud's points (None without a cloud.ply)."""
    sc = sfmdata.load(os.path.join(work, "sfm.sfm"))
    posed = sc.valid_views()
    rows = sc.view_pose[posed]
    est_c, est_R = sc.pose_c[rows], sc.pose_R[rows]
    s, Ra, t = _align_similarity(est_c, c_true[posed])
    aligned = est_c @ (s * Ra).T + t
    ate = float(np.sqrt(np.mean(np.sum((aligned - c_true[posed]) ** 2, axis=1))))
    radius = float(np.linalg.norm(c_true[:, :2], axis=1).mean())
    rot, Ro = rotation_errors_deg(est_R, R_true[posed])
    depth_med, depth_valid = [], []
    for v in posed:
        d = np.load(os.path.join(work, "depth", f"{int(sc.view_ids[v])}_depth.npy"))
        gt_v = gt[v, ::downscale, ::downscale]
        if d.shape != gt_v.shape or not np.isfinite(d).all():
            raise RuntimeError(f"view {v + 1}: depth map {d.shape} not finite or not {gt_v.shape}")
        med, frac = depth_stats(d * s, gt_v)
        depth_med.append(med)
        depth_valid.append(frac)
    n_cloud = None
    if os.path.exists(os.path.join(work, "cloud.ply")):
        with open(os.path.join(work, "cloud.ply")) as f:
            n_cloud = int([next(f) for _ in range(3)][2].split()[-1])
    return {
        "posed": [int(v) + 1 for v in posed],
        "n_posed": len(posed),
        "landmarks": int(sc.n_landmarks),
        "ate": ate,
        "ate_frac_of_radius": ate / radius,
        "rotation_err_deg": rot,
        "centre_vs_orientation_alignment_deg": _angle_deg(Ra @ Ro.T),
        "scale": float(s),
        "focal_px": sc.scale.tolist(),
        "depth_median_rel_err": depth_med,
        "depth_valid_frac": depth_valid,
        "cloud_points": n_cloud,
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
    split = focal_split(dev, work, out, rep["focal_px"])
    print("pipeline focal split " + json.dumps(split), flush=True)
    row = {
        "focal_split": split,
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


# --------------------------------------------------------------- photos

# The photos phase: photographs (JPEG bytes with EXIF) through the port's
# own codec (image/jpeg.py over native/jpeg.cpp) and EXIF reader
# (image/exif.py), on a machine with no image codec library. (a) the
# committed fixtures against PIL's decode (fixtures.json, written by
# scripts/make_jpeg_fixtures.py where PIL exists) and the plain decoder;
# (b) a 24 MP photograph (the aux phase's generator) encoded at quality
# 95, 4:2:0, and decoded: seconds, MP/s, the decode's host peak, the
# round trip's PSNR against its floor (43.4888 dB on the CPU: integer
# arithmetic, the same on every host), and C++ against plain on a 512 px
# crop; (c) the pipeline phase's 8 views as quality-95 JPEGs (grey in
# three channels, as tests/test_pipeline_photos.py writes them) with the
# camera's FocalLength in the Exif sub-IFD, through run_full_pipeline with
# no default focal, held to the pipeline phase's gates (the rotations
# within PHOTO_ROT_DEG), the EXIF focal within 0.5 % and 4 SGM launches a
# map of every view (32); (d) the JAX photo test's operating
# point (tests/test_pipeline_photos.py:54-128): 40 distorted 640x480 views
# rendered on the card, cameraInit from EXIF -> DSP-SIFT at 4096 ->
# voctree pairs (6) -> featureMatching -> incrementalSfm, at its gates.
PHOTO_FIXTURES = os.path.join(ROOT, "alicevision_tpu_torch", "data", "jpeg_fixtures")
PHOTO_CAMERA = ("Canon", "Canon EOS 5D Mark III")
PHOTO_SENSOR_MM = 36.0  # its sensor width in the port's sensor database
PHOTO_QUALITY = 95
PHOTO_24MP_WH = (6000, 4000)
PHOTO_PSNR_FLOOR = 43.4
PHOTO_CROP = 512
PHOTO_EXIF_FOCAL = 0.005
# The photo pipeline's rotation gate. On this 0.6 rad arc fy is weakly
# observed and follows the RANSAC draws in both engines (ROADMAP §3), and
# the largest rotation error with it: on the port's CPU front end the JAX
# engine's seeds 0-7 read 0.227-1.508 deg (3 of 8 above 1 deg), the port's
# 0.225-0.842 (scripts/focal_parting.py); the card's JPEG run read 1.126
# (fy 1023 px). The gate is the cli phase's 2 deg, above every JAX draw;
# the other gates are the pipeline phase's.
PHOTO_ROT_DEG = 2.0
PHOTO_HARD = dict(n_views=40, wh=(640, 480), focal_px=450.0, disto=(-0.25, 0.06, -0.005), max_keypoints=4096,
                  n_neighbors=6)
PHOTO_HARD_GATES = dict(min_posed=39, ate=0.012, focal=0.03, k1=(-0.40, -0.12))
FOCAL_FIXTURE = os.path.join(ROOT, "tests", "golden", "focal_parting_tracks.npz")


def write_photos(folder: str, imgs: np.ndarray, focal_px: float, names=None, quality: int = PHOTO_QUALITY) -> float:
    """Grey float views -> RGB JPEGs (the grey in all three channels) at
    `quality`, 4:2:0, with the camera's Make, Model and FocalLength (in the
    Exif sub-IFD, where cameras write it). Returns the focal in mm."""
    focal_mm = focal_px * PHOTO_SENSOR_MM / imgs.shape[2]
    app1 = exif.exif_app1(*PHOTO_CAMERA, focal_mm)
    os.makedirs(folder, exist_ok=True)
    for v in range(len(imgs)):
        u8 = np.clip(imgs[v] * 255.0, 0, 255).astype(np.uint8)
        data = exif.insert_app1(jpeg.encode(np.dstack([u8] * 3), quality), app1)
        with open(os.path.join(folder, names[v] if names else f"view_{v:03d}.jpg"), "wb") as f:
            f.write(data)
    return focal_mm


def check_jpeg_fixtures() -> dict:
    """Every committed fixture decoded by the C++ and the plain decoder
    against PIL's SHA-256, and its EXIF and size against PIL's reading."""
    import hashlib

    from alicevision_tpu_torch.image.io import read_exif

    with open(os.path.join(PHOTO_FIXTURES, "fixtures.json")) as f:
        table = json.load(f)
    misses, total = [], 0
    t0 = time.perf_counter()
    for name, want in sorted(table.items()):
        path = os.path.join(PHOTO_FIXTURES, name)
        with open(path, "rb") as f:
            data = f.read()
        total += len(data)
        for route, decode in (("C++", jpeg.decode), ("plain", jpeg.decode_plain)):
            got = decode(data)
            if list(got.shape) != want["shape"] or hashlib.sha256(got.tobytes()).hexdigest() != want["sha256"]:
                misses.append(f"{name}: the {route} decode is not PIL's")
        meta = read_exif(path)
        size = [meta.pop("height"), meta.pop("width")]
        if size != want["shape"][:2] or meta != want["exif"]:
            misses.append(f"{name}: EXIF {meta} at {size}, PIL read {want['exif']} at {want['shape'][:2]}")
    return {"fixtures": len(table), "bytes": total, "seconds": time.perf_counter() - t0, "misses": misses}


def _host_peak(fn):
    """fn() with this process's resident memory sampled every 5 ms: (its
    result, the peak above the resident memory at the start, in bytes)."""
    import threading

    base = _resident_bytes(os.getpid()) or 0
    peak, done = [base], threading.Event()

    def sample():
        while not done.is_set():
            peak[0] = max(peak[0], _resident_bytes(os.getpid()) or 0)
            time.sleep(0.005)

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        out = fn()
    finally:
        done.set()
        th.join()
    return out, max(peak[0] - base, 0)


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * math.log10(255.0**2 / mse)


def photo_round_trip(wh=PHOTO_24MP_WH, crop: int = PHOTO_CROP, quality: int = PHOTO_QUALITY) -> dict:
    """A photograph of `wh` encoded and decoded by the port's codec, and a
    `crop`-px corner of it decoded by the C++ and by the plain decoder."""
    t0 = time.perf_counter()
    src = np.clip(aux_photo(wh) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    made = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = jpeg.encode(src, quality)
    enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    img, peak = _host_peak(lambda: jpeg.decode(data))
    dec = time.perf_counter() - t0
    corner = jpeg.encode(np.ascontiguousarray(src[:crop, :crop]), quality)
    t0 = time.perf_counter()
    plain = jpeg.decode_plain(corner)
    plain_s = time.perf_counter() - t0
    mp = wh[0] * wh[1] / 1e6
    return {"wh": list(wh), "quality": quality, "jpeg_bytes": len(data), "make_s": made, "encode_s": enc,
            "encode_mp_s": mp / enc, "decode_s": dec, "decode_mp_s": mp / dec, "decode_host_peak_gib": peak / 2**30,
            "psnr_db": _psnr(img, src), "shape_ok": img.shape == src.shape, "crop": crop,
            "crop_plain_equal": bool(np.array_equal(jpeg.decode(corner), plain)), "crop_plain_s": plain_s}


def photo_pipeline(dev, work: str, image_folder: str, posed_sfm: str, gt: np.ndarray) -> dict:
    """The pipeline phase's views as camera JPEGs through run_full_pipeline
    with no default focal (cameraInit: EXIF -> sensor database)."""
    truth = sfmdata.load(posed_sfm)
    names = sorted(f for f in os.listdir(image_folder) if f.endswith(".npy"))
    imgs = np.stack([np.load(os.path.join(image_folder, n)) for n in names])
    folder = os.path.join(work, "photos_images")
    t0 = time.perf_counter()
    focal_mm = write_photos(folder, imgs, 1120.0, names=[n[:-4] + ".jpg" for n in names])
    write_s = time.perf_counter() - t0
    out = os.path.join(work, "photos_pipe")
    seconds, launches = run_pipeline(out, folder, dev, focal_px=None)
    rep = pipeline_report(out, truth.pose_R[truth.view_pose], truth.pose_c[truth.view_pose], gt)
    return {"views": len(names), "write_jpeg_s": write_s, "exif_focal_mm": focal_mm,
            "camera_init_focal_px": float(sfmdata.load(os.path.join(out, "cameraInit.sfm")).scale[0, 0]),
            "stage_seconds": seconds, "sgm_launches": launches,
            "depth_maps": len(os.listdir(os.path.join(out, "depth"))) // 2, **rep}


def hard_photos(dev, work: str, cfg=PHOTO_HARD) -> dict:
    """tests/test_pipeline_photos.py's run through the port's stages, the
    views rendered on `dev` (render_hard_views) and written as camera
    JPEGs."""
    from alicevision_tpu_torch.utils.rendered import render_hard_views

    cuda = torch.device(dev).type == "cuda"
    seconds = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        if cuda:
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return res

    imgs, _, _, _, c_gt = timed("render", render_hard_views, cfg["n_views"], cfg["wh"], focal_px=cfg["focal_px"],
                                disto=cfg["disto"], device=dev)
    p = lambda *x: os.path.join(work, "photos_hard", *x)  # noqa: E731
    timed("write_jpeg", write_photos, p("images"), np.asarray(imgs), cfg["focal_px"])
    scene = timed("cameraInit", stages.camera_init, p("images"), p("cameraInit.sfm"), device=dev)
    timed("featureExtraction", stages.feature_extraction, p("cameraInit.sfm"), p("features"),
          max_keypoints=cfg["max_keypoints"], downscale_to=0, describer_types="dspsift", device=dev)
    timed("imageMatching", stages.image_matching, p("cameraInit.sfm"), p("features"), p("pairs.txt"),
          method="voctree", n_neighbors=cfg["n_neighbors"], device=dev)
    timed("featureMatching", stages.feature_matching, p("cameraInit.sfm"), p("features"), p("pairs.txt"),
          p("matches.npz"), device=dev)
    out = timed("incrementalSfm", stages.incremental_sfm, p("cameraInit.sfm"), p("features"), p("matches.npz"),
                p("sfm.sfm"), device=dev)
    posed = out.valid_views()
    ate, _ = _ate_rel(out.pose_c[out.view_pose[posed]], c_gt[posed], c_gt)
    return {"views": cfg["n_views"], "wh": list(cfg["wh"]), "posed": int(len(posed)), "ate_frac_of_radius": ate,
            "exif_focal_px": float(scene.scale[0, 0]), "focal_px": out.scale[0].tolist(),
            "focal_true": cfg["focal_px"], "k1": float(out.disto[0][0]), "k1_true": cfg["disto"][0],
            "landmarks": int(out.n_landmarks), "stage_seconds": seconds}


def photos_misses(row: dict, gates=PHOTO_HARD_GATES) -> list:
    """The gates of the photos phase that `row` misses."""
    bad = list(row["fixtures"]["misses"])
    rt = row["photo_24mp"]
    if not (rt["shape_ok"] and rt["psnr_db"] >= PHOTO_PSNR_FLOOR):
        bad.append(f"24 MP round trip at {rt['psnr_db']:.4f} dB, expected at least {PHOTO_PSNR_FLOOR}")
    if not rt["crop_plain_equal"]:
        bad.append("the 24 MP photograph's crop: C++ and plain decodes differ")
    pp = row["pipeline"]
    if not abs(pp["camera_init_focal_px"] - 1120.0) / 1120.0 < PHOTO_EXIF_FOCAL:
        bad.append(f"cameraInit focal {pp['camera_init_focal_px']:.2f} px, expected within 0.5 % of 1120")
    want = {"sgm_directional_pass": 0, "sgm_axis_sweeps": LAUNCHES_PER_MAP * pp["views"]}
    if pp["sgm_launches"] != want or pp["depth_maps"] != pp["n_posed"]:
        bad.append(f"{pp['depth_maps']} depth maps, SGM launches {pp['sgm_launches']}, expected {want} "
                   f"(4 a map of each of the {pp['views']} views)")
    if pp["n_posed"] < PIPE_MIN_POSED:
        bad.append(f"{pp['n_posed']} views posed, expected at least {PIPE_MIN_POSED}")
    if pp["ate_frac_of_radius"] >= PIPE_ATE_FRAC:
        bad.append(f"camera-centre ATE {pp['ate_frac_of_radius']:.4f} of the radius, expected < {PIPE_ATE_FRAC}")
    if max(pp["rotation_err_deg"]) >= PHOTO_ROT_DEG:
        bad.append(f"rotation errors {pp['rotation_err_deg']} deg, expected < {PHOTO_ROT_DEG}")
    if pp["landmarks"] < PIPE_MIN_LANDMARKS:
        bad.append(f"{pp['landmarks']} landmarks, expected at least {PIPE_MIN_LANDMARKS}")
    missed = [v for v, m, f in zip(pp["posed"], pp["depth_median_rel_err"], pp["depth_valid_frac"])
              if not (m < PIPE_DEPTH_MED and f > PIPE_DEPTH_VALID)]
    if missed:
        bad.append(f"views {missed} miss the depth floors (<{PIPE_DEPTH_MED}, >{PIPE_DEPTH_VALID})")
    if not (pp["cloud_points"] or 0) > PIPE_MIN_CLOUD:
        bad.append(f"cloud.ply holds {pp['cloud_points']} points, expected more than {PIPE_MIN_CLOUD}")
    hp = row.get("hard")
    if hp is not None:
        f_true = hp["focal_true"]
        if hp["posed"] < gates["min_posed"]:
            bad.append(f"hard photos: {hp['posed']} of {hp['views']} posed, expected at least {gates['min_posed']}")
        if not hp["ate_frac_of_radius"] < gates["ate"]:
            bad.append(f"hard photos: ATE {hp['ate_frac_of_radius']:.5f} of the radius, expected < {gates['ate']}")
        if not abs(float(np.mean(hp["focal_px"])) - f_true) / f_true < gates["focal"]:
            bad.append(f"hard photos: focal {hp['focal_px']}, expected within 3 % of {f_true}")
        if not gates["k1"][0] < hp["k1"] < gates["k1"][1]:
            bad.append(f"hard photos: k1 {hp['k1']:.4f}, expected in {gates['k1']}")
        if not abs(hp["exif_focal_px"] - f_true) / f_true < PHOTO_EXIF_FOCAL:
            bad.append(f"hard photos: EXIF focal {hp['exif_focal_px']:.2f} px, expected within 0.5 % of {f_true}")
    return bad


def run_photos_phase(dev, work: str, image_folder: str, posed_sfm: str, gt: np.ndarray, npy_seconds=None,
                     smi: str = "", wh_24mp=PHOTO_24MP_WH, hard_cfg=PHOTO_HARD) -> tuple:
    """The photos phase (see its constants): (the `photos` row, the SGM
    launches of its pipeline run). `hard_cfg=None` leaves out (d)."""
    t_phase = time.perf_counter()
    row = {"device": smi, "fixtures": check_jpeg_fixtures(), "photo_24mp": photo_round_trip(wh_24mp)}
    row["pipeline"] = photo_pipeline(dev, work, image_folder, posed_sfm, gt)
    row["pipeline"]["stage_seconds_npy_warm"] = npy_seconds
    if hard_cfg is not None:
        row["hard"] = hard_photos(dev, work, hard_cfg)
    row["seconds"] = time.perf_counter() - t_phase
    return row, dict(row["pipeline"]["sgm_launches"])


def check_photos(dev, work: str, image_folder: str, posed_sfm: str, gt: np.ndarray, npy_seconds, smi: str) -> tuple:
    row, launches = run_photos_phase(dev, work, image_folder, posed_sfm, gt, npy_seconds, smi)
    row["misses"] = photos_misses(row)
    print("photos " + json.dumps(row), flush=True)
    if row["misses"]:
        raise RuntimeError("photos: " + "; ".join(row["misses"]))
    return row, launches


def load_focal_fixture(path: str = FOCAL_FIXTURE) -> dict:
    """The port's CPU front end on the pipeline phase's views, as tracks
    (scripts/focal_parting.py --write-fixture): the track arrays, each
    view's feature positions, the intrinsics row and the image sizes."""
    with np.load(path) as z:
        n_views = len(z["view_intrinsic"])
        return dict(
            tracks=(z["track_ids"], z["views"], z["features"], int(z["n_tracks"])),
            xy={v: z[f"xy_{v}"] for v in range(n_views)},
            intr=[z[f"intr_{i}"] for i in range(sum(k.startswith("intr_") for k in z.files))],
            view_intrinsic=z["view_intrinsic"], image_sizes=z["image_sizes"],
        )


def focal_split(dev, work: str, card_run: str, card_focal) -> dict:
    """The 8-view arc's (fx, fy) for each front end through each engine,
    all at the engine's defaults (seed 0): the port's CPU front end on
    these views (tests/golden/focal_parting_tracks.npz, written by
    scripts/focal_parting.py) and the card's (`card_run`, the pipeline
    phase's warm run, whose card engine read `card_focal`), each through
    the CPU engine and the card's."""
    from alicevision_tpu_torch.convert import tracks_from_numpy
    from alicevision_tpu_torch.sfm.incremental import IncrementalConfig, IncrementalSfM

    fx = load_focal_fixture()
    out, seconds = {}, {}
    for name, device in (("cpu_front_cpu_engine", "cpu"), ("cpu_front_card_engine", dev)):
        t0 = time.perf_counter()
        e = IncrementalSfM(tracks_from_numpy(*fx["tracks"]), fx["xy"], fx["intr"], fx["view_intrinsic"],
                           fx["image_sizes"], IncrementalConfig(seed=0), device=device)
        e.process()
        out[name] = np.asarray(e.intr_np.scale, np.float64).ravel().tolist()
        seconds[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc = stages.incremental_sfm(os.path.join(card_run, "cameraInit.sfm"), os.path.join(card_run, "features"),
                                os.path.join(card_run, "matches.npz"), os.path.join(work, "split_cpu.sfm"),
                                device="cpu")
    out["card_front_cpu_engine"] = np.asarray(sc.scale[0], np.float64).tolist()
    seconds["card_front_cpu_engine"] = time.perf_counter() - t0
    out["card_front_card_engine"] = [float(x) for x in np.ravel(card_focal)]
    return {"focal_px": out, "seconds": seconds}


# --------------------------------------------------------------- codecs


def _riff_chunk(fcc: bytes, body: bytes) -> bytes:
    return fcc + struct.pack("<L", len(body)) + body + b"\0" * (len(body) & 1)


AVI_FPS = 30


def _riff_list(kind: bytes, body: bytes) -> bytes:
    return b"LIST" + struct.pack("<L", len(body) + 4) + kind + body


def mjpeg_avi(frames: list, w: int, h: int, codec: bytes = b"MJPG") -> bytes:
    """An AVI of one video stream at AVI_FPS whose frames are the given JPEG
    bytes: hdrl (avih, strl: strh, strf), movi ('00dc' chunks; an empty one
    is a dropped frame) and an idx1 index, as a capture tool writes it."""
    n, big, fps = len(frames), max(len(f) for f in frames), AVI_FPS
    avih = struct.pack("<14L", 1000000 // fps, big * fps, 0, 0x10, n, 0, 1, big, w, h, 0, 0, 0, 0)
    strh = b"vids" + codec + struct.pack("<LHHLLLLLLlL4h", 0, 0, 0, 0, 1, fps, 0, n, big, -1, 0, 0, 0, w, h)
    strf = struct.pack("<LllHH4sLllLL", 40, w, h, 1, 24, codec, w * h * 3, 0, 0, 0, 0)
    hdrl = _riff_list(b"hdrl", _riff_chunk(b"avih", avih)
                      + _riff_list(b"strl", _riff_chunk(b"strh", strh) + _riff_chunk(b"strf", strf)))
    movi, idx, off = [], [], 4
    for f in frames:
        c = _riff_chunk(b"00dc", f)
        idx.append(b"00dc" + struct.pack("<LLL", 0x10 if f else 0, off, len(f)))
        movi.append(c)
        off += len(c)
    body = b"AVI " + hdrl + _riff_list(b"movi", b"".join(movi)) + _riff_chunk(b"idx1", b"".join(idx))
    return b"RIFF" + struct.pack("<L", len(body)) + body


# The codecs phase: the port's own TIFF, BMP, PNG and MJPEG AVI readers
# (image/{tiff,bmp,png,avi}.py over native/codecs.cpp, built with g++) on
# a machine with no imageio, PIL or OpenCV. (a) every committed fixture
# (data/codec_fixtures, scripts/make_codec_fixtures.py) through the C++
# and the plain routes against the JAX package's reading recorded in
# fixtures.json (or the port's recorded parting), its EXIF too, and the
# AVIs' frames against PIL's decode of each chunk and cv2's frame count;
# (b) a 24 MP (6000x4000) 16-bit RGB TIFF twice: LZW with predictor 2,
# every StripOffsets entry pointing at the one committed strip (legal
# TIFF), and deflate with predictor 2 (zlib, built here), each decoded
# with its seconds, MP/s and host peak, and held to the strip decoded
# alone (C++ and plain) and to the image it was built from; (c) a 24 MP
# 24-bit BMP written and read back; (d) the pipeline phase's 8 views as
# 16-bit RGB TIFFs (deflate with predictor 2 or uncompressed, II or MM),
# the camera's Make, Model and FocalLength in IFD0 for four and in the
# Exif sub-IFD for four, through run_full_pipeline with no default focal:
# cameraInit at 1120.0 px for all 8, the pipeline gates with the photos
# phase's 2 deg rotation gate, 32 SGM launches; (e) a 1920x1080 MJPEG AVI
# of 60 frames (a pan over aux_photo, two frames in three blurred,
# encoded by image/jpeg.encode, wrapped by mjpeg_avi) through
# `av keyframeSelection --method smart` on the card, its frames/s, and the
# selected indices equal to the same command on the AVI's frames saved as
# .npy.
CODEC_FIXTURES = os.path.join(ROOT, "alicevision_tpu_torch", "data", "codec_fixtures")
CODEC_24MP_WH = (6000, 4000)
CODEC_STRIP_ROWS = 4
CODEC_DEFLATE_ROWS = 16
CODEC_AVI = dict(wh=(1920, 1080), frames=60, pan_px=4, quality=90, sharp_every=3, blur_sigma=2.0)
CODEC_VIEW_FOCAL_MM = 31.5  # 1120 px on the Canon EOS 5D Mark III's 36 mm sensor at 1280 px


def _digest(a: np.ndarray) -> list:
    """[dtype, shape, SHA-256] of an array (bools as 0 / 1 bytes)."""
    import hashlib

    a = np.ascontiguousarray(a != 0 if a.dtype == bool else a)
    return [a.dtype.name, list(a.shape), hashlib.sha256(a.tobytes()).hexdigest()]


def check_codec_fixtures() -> dict:
    """Every committed fixture against fixtures.json: the C++ and the plain
    routes, the EXIF, the refusals, and the AVIs' frames."""
    from alicevision_tpu_torch.image import avi, bmp, png, tiff
    from alicevision_tpu_torch.image.io import read_exif

    with open(os.path.join(CODEC_FIXTURES, "fixtures.json")) as f:
        table = json.load(f)
    routes = {".tif": (tiff.read_tiff, lambda p: tiff.read_tiff(p, plain=True)),
              ".png": (png.read_png, lambda p: png.read_png(p, plain=True)), ".bmp": (bmp.read_bmp,)}
    misses, total, t0 = [], 0, time.perf_counter()
    for name, row in sorted(table.items()):
        path = os.path.join(CODEC_FIXTURES, name)
        total += os.path.getsize(path)
        want = {**row.get("jax", {}), **row.get("port", {})}
        ext = os.path.splitext(name)[1]
        if ext == ".avi":
            try:
                got = [_digest(f)[2] for f, _ in avi.read_frames(path)]
            except ValueError as e:
                got = str(e)
            if "raises" in want:
                if not (isinstance(got, str) and want["raises"] in got):
                    misses.append(f"{name}: expected a ValueError naming {want['raises']}, got {got}")
            elif got != [r["sha256"] for r in row["frames"]] or len(got) != row["cv2_frames"]:
                misses.append(f"{name}: frames are not PIL's decode, or not cv2's {row['cv2_frames']}")
            continue
        for k, read in enumerate(routes[ext]):
            try:
                got = _digest(read(path))
            except ValueError as e:
                got = str(e)
            if "raises" in want:
                if not (isinstance(got, str) and want["raises"] in got):
                    misses.append(f"{name}: expected a ValueError naming {want['raises']}, got {got}")
            elif got != [want["dtype"], want["shape"], want["sha256"]]:
                misses.append(f"{name}: the {('C++', 'plain')[k]} read {got[:2]} is not the recorded one")
        if "raises" not in want:
            meta, exp = read_exif(path), row.get("port", {}).get("exif", row["jax"]["exif"])
            if meta != exp:
                misses.append(f"{name}: EXIF {meta}, expected {exp}")
    return {"fixtures": len(table), "bytes": total, "seconds": time.perf_counter() - t0, "misses": misses}


def _timed_read(fn, path: str) -> tuple:
    t0 = time.perf_counter()
    img, peak = _host_peak(lambda: fn(path))
    return img, time.perf_counter() - t0, peak


def _predict2(img: np.ndarray) -> np.ndarray:
    """TIFF predictor 2: horizontal differences of each sample, wrapping."""
    out = img.copy()
    out[:, 1:] -= img[:, :-1]
    return out


def tiff_24mp(work: str) -> dict:
    """The 24 MP 16-bit RGB TIFF, LZW (the committed strip, replicated by
    offset) and deflate (built here), each decoded and checked."""
    from alicevision_tpu_torch import native
    from alicevision_tpu_torch.image import exif, tiff

    W, H = CODEC_24MP_WH
    with open(os.path.join(CODEC_FIXTURES, "lzw_strip.tif"), "rb") as f:
        data = f.read()
    bo, off = tiff.tiff_header(data)
    tags = exif._ifd(data, off, bo)
    if (tags[tiff.WIDTH], tags[tiff.HEIGHT]) != (W, CODEC_STRIP_ROWS):
        raise RuntimeError(f"lzw_strip.tif is {tags[tiff.WIDTH]}x{tags[tiff.HEIGHT]}, expected {W}x{CODEC_STRIP_ROWS}")
    strip = data[tags[tiff.STRIP_OFFSETS]:tags[tiff.STRIP_OFFSETS] + tags[tiff.STRIP_COUNTS]]
    n = W * CODEC_STRIP_ROWS * 6
    t0 = time.perf_counter()
    alone = native.lzw_decode(strip, n)
    strip_s = time.perf_counter() - t0
    plain_equal = bool(np.array_equal(alone, np.frombuffer(tiff._lzw_decode_plain(strip, n), np.uint8)))
    strip_img = tiff._samples(alone, CODEC_STRIP_ROWS, W, 3, np.uint16, bo, 2)
    reps = H // CODEC_STRIP_ROWS
    lzw_path = os.path.join(work, "lzw_24mp.tif")
    with open(lzw_path, "wb") as f:
        f.write(tiff.assemble(W, H, 3, 16, [strip] * reps, CODEC_STRIP_ROWS, order="II" if bo == "<" else "MM",
                              compression=5, predictor=2))
    img, lzw_s, lzw_peak = _timed_read(tiff.read_tiff, lzw_path)
    lzw_equal = bool(img.shape == (H, W, 3) and (img.reshape(reps, CODEC_STRIP_ROWS, W, 3) == strip_img).all())
    del img
    # deflate: the strip image tiled, each row offset so no two strips are equal
    src = np.tile(strip_img, (reps, 1, 1)) + (np.arange(H, dtype=np.uint16) * np.uint16(37))[:, None, None]
    t0 = time.perf_counter()
    pred = _predict2(src).astype("<u2")
    strips = [zlib.compress(pred[y:y + CODEC_DEFLATE_ROWS].tobytes(), 1) for y in range(0, H, CODEC_DEFLATE_ROWS)]
    build_s = time.perf_counter() - t0
    del pred
    defl_path = os.path.join(work, "deflate_24mp.tif")
    with open(defl_path, "wb") as f:
        f.write(tiff.assemble(W, H, 3, 16, strips, CODEC_DEFLATE_ROWS, compression=8, predictor=2))
    img, defl_s, defl_peak = _timed_read(tiff.read_tiff, defl_path)
    defl_equal = bool(np.array_equal(img, src))
    mp = W * H / 1e6
    return {"wh": [W, H], "lzw": {"file_bytes": os.path.getsize(lzw_path), "strips": reps, "decode_s": lzw_s,
                                    "decode_mp_s": mp / lzw_s, "host_peak_gib": lzw_peak / 2**30,
                                    "equal_to_strip": lzw_equal, "strip_plain_equal": plain_equal,
                                    "strip_decode_s": strip_s},
            "deflate": {"file_bytes": os.path.getsize(defl_path), "build_s": build_s, "decode_s": defl_s,
                        "decode_mp_s": mp / defl_s, "host_peak_gib": defl_peak / 2**30, "equal": defl_equal}}


def bmp_24mp(work: str) -> dict:
    """A 24 MP 24-bit BMP written and read back by the port."""
    from alicevision_tpu_torch.image import bmp

    W, H = CODEC_24MP_WH
    y, x = np.mgrid[0:H, 0:W].astype(np.uint16)
    src = np.stack([(x >> 4) & 255, (y >> 4) & 255, (x ^ y) & 255], -1).astype(np.uint8)
    del y, x
    path = os.path.join(work, "24mp.bmp")
    t0 = time.perf_counter()
    bmp.write_bmp(path, src)
    write_s = time.perf_counter() - t0
    img, read_s, peak = _timed_read(bmp.read_bmp, path)
    mp = W * H / 1e6
    return {"wh": [W, H], "file_bytes": os.path.getsize(path), "write_s": write_s, "read_s": read_s,
            "read_mp_s": mp / read_s, "host_peak_gib": peak / 2**30, "equal": bool(np.array_equal(img, src))}


def write_tiff_views(folder: str, imgs: np.ndarray, names: list, focal_mm: float = CODEC_VIEW_FOCAL_MM) -> None:
    """Grey float views -> 16-bit RGB camera TIFFs (the grey in three
    channels): even views deflate with predictor 2, odd ones uncompressed;
    views 0-3 in II with Make, Model and FocalLength in IFD0, views 4-7 in
    MM with FocalLength in the Exif sub-IFD."""
    from alicevision_tpu_torch.image import exif, tiff

    os.makedirs(folder, exist_ok=True)
    for v, name in enumerate(names):
        u16 = np.round(np.clip(imgs[v], 0, 1) * 65535).astype(np.uint16)
        rgb = np.repeat(u16[..., None], 3, axis=2)
        order, where = ("II", "ifd0") if v < 4 else ("MM", "exif")
        bo = "<" if order == "II" else ">"
        ifd0, sub = exif.camera_tags(*PHOTO_CAMERA, focal_mm, bo, where)
        h, w = u16.shape
        if v % 2 == 0:
            pred = _predict2(rgb).astype(np.dtype(np.uint16).newbyteorder(bo))
            strips = [zlib.compress(pred[y:y + 16].tobytes(), 6) for y in range(0, h, 16)]
            data = tiff.assemble(w, h, 3, 16, strips, 16, order, compression=8, predictor=2,
                                 ifd0_extra=ifd0, exif_tags=sub)
        else:
            data = tiff.tiff_bytes(rgb, order=order, ifd0_extra=ifd0, exif_tags=sub)
        with open(os.path.join(folder, name), "wb") as f:
            f.write(data)


def tiff_pipeline(dev, work: str, image_folder: str, posed_sfm: str, gt: np.ndarray) -> dict:
    """The pipeline phase's views as camera TIFFs through run_full_pipeline
    with no default focal (cameraInit: EXIF -> sensor database)."""
    truth = sfmdata.load(posed_sfm)
    names = sorted(f for f in os.listdir(image_folder) if f.endswith(".npy"))
    imgs = np.stack([np.load(os.path.join(image_folder, n)) for n in names])
    folder = os.path.join(work, "tiff_images")
    t0 = time.perf_counter()
    write_tiff_views(folder, imgs, [n[:-4] + ".tif" for n in names])
    write_s = time.perf_counter() - t0
    out = os.path.join(work, "tiff_pipe")
    seconds, launches = run_pipeline(out, folder, dev, focal_px=None)
    rep = pipeline_report(out, truth.pose_R[truth.view_pose], truth.pose_c[truth.view_pose], gt)
    init = sfmdata.load(os.path.join(out, "cameraInit.sfm"))
    focals = [float(init.scale[i, 0]) for i in np.asarray(init.view_intrinsic)]
    return {"views": len(names), "write_tiff_s": write_s, "camera_init_focal_px": focals,
            "stage_seconds": seconds, "sgm_launches": launches,
            "depth_maps": len(os.listdir(os.path.join(out, "depth"))) // 2, **rep}


def avi_keyframes(dev, work: str, cfg=CODEC_AVI) -> dict:
    """The 1080p MJPEG AVI through `av keyframeSelection --method smart`,
    and the same command on its frames saved as .npy."""
    from alicevision_tpu_torch.image import jpeg
    from alicevision_tpu_torch.image.feeds import video_feed
    from alicevision_tpu_torch.image.filtering import gaussian_blur
    from alicevision_tpu_torch.pipeline import cli

    W, H = cfg["wh"]
    n = cfg["frames"]
    t0 = time.perf_counter()
    pano = aux_photo((W + cfg["pan_px"] * n, H))
    frames = []
    for k in range(n):
        img = torch.from_numpy(np.ascontiguousarray(pano[:, cfg["pan_px"] * k:cfg["pan_px"] * k + W]))
        if k % cfg["sharp_every"] != 1:
            img = gaussian_blur(img.to(dev).permute(2, 0, 1), cfg["blur_sigma"]).permute(1, 2, 0).cpu()
        u8 = np.clip(img.numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)
        frames.append(jpeg.encode(u8, cfg["quality"]))
    path = os.path.join(work, "clip.avi")
    with open(path, "wb") as f:
        f.write(mjpeg_avi(frames, W, H))
    make_s = time.perf_counter() - t0
    rows = {}
    for tag, src in (("avi", path), ("npy", os.path.join(work, "clip_npy"))):
        if tag == "npy":
            t0 = time.perf_counter()
            os.makedirs(src, exist_ok=True)
            for img, i in video_feed(path, grayscale=True):
                np.save(os.path.join(src, f"f{i:03d}.npy"), img)
            rows["npy_write_s"] = time.perf_counter() - t0
        out = os.path.join(work, f"keyframes_{tag}.txt")
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["keyframeSelection", "--inputFolder", src, "--output", out, "--method", "smart",
                       "--device", str(torch.device(dev).type)])
        sec = time.perf_counter() - t0
        with open(out) as f:
            picked = [int(re.sub(r"\D", "", name)) for name in f.read().split()]
        rows[tag] = {"rc": rc, "seconds": sec, "frames_per_s": n / sec, "selected": picked}
    return {"wh": [W, H], "frames": n, "avi_bytes": os.path.getsize(path), "make_s": make_s, **rows,
            "equal": rows["avi"]["selected"] == rows["npy"]["selected"] and rows["avi"]["rc"] == 0}


def codecs_misses(row: dict) -> list:
    """The gates of the codecs phase that `row` misses."""
    bad = list(row["fixtures"]["misses"])
    t = row["tiff_24mp"]
    if not (t["lzw"]["equal_to_strip"] and t["lzw"]["strip_plain_equal"]):
        bad.append("24 MP LZW TIFF: not its strip, or the strip's C++ and plain decodes differ")
    if not t["deflate"]["equal"]:
        bad.append("24 MP deflate TIFF: not the image it was built from")
    if not row["bmp_24mp"]["equal"]:
        bad.append("24 MP BMP: read back unequal")
    pp = row["pipeline"]
    if any(f != 1120.0 for f in pp["camera_init_focal_px"]) or len(pp["camera_init_focal_px"]) != pp["views"]:
        bad.append(f"cameraInit focals {pp['camera_init_focal_px']}, expected 1120.0 for all {pp['views']}")
    want = {"sgm_directional_pass": 0, "sgm_axis_sweeps": LAUNCHES_PER_MAP * pp["views"]}
    if pp["sgm_launches"] != want or pp["depth_maps"] != pp["n_posed"]:
        bad.append(f"{pp['depth_maps']} depth maps, SGM launches {pp['sgm_launches']}, expected {want}")
    if pp["n_posed"] < PIPE_MIN_POSED:
        bad.append(f"{pp['n_posed']} views posed, expected at least {PIPE_MIN_POSED}")
    if pp["ate_frac_of_radius"] >= PIPE_ATE_FRAC:
        bad.append(f"camera-centre ATE {pp['ate_frac_of_radius']:.4f} of the radius, expected < {PIPE_ATE_FRAC}")
    if max(pp["rotation_err_deg"]) >= PHOTO_ROT_DEG:
        bad.append(f"rotation errors {pp['rotation_err_deg']} deg, expected < {PHOTO_ROT_DEG}")
    if pp["landmarks"] < PIPE_MIN_LANDMARKS:
        bad.append(f"{pp['landmarks']} landmarks, expected at least {PIPE_MIN_LANDMARKS}")
    missed = [v for v, m, f in zip(pp["posed"], pp["depth_median_rel_err"], pp["depth_valid_frac"])
              if not (m < PIPE_DEPTH_MED and f > PIPE_DEPTH_VALID)]
    if missed:
        bad.append(f"views {missed} miss the depth floors (<{PIPE_DEPTH_MED}, >{PIPE_DEPTH_VALID})")
    if not (pp["cloud_points"] or 0) > PIPE_MIN_CLOUD:
        bad.append(f"cloud.ply holds {pp['cloud_points']} points, expected more than {PIPE_MIN_CLOUD}")
    kf = row["keyframes"]
    if not kf["equal"] or not kf["avi"]["selected"]:
        bad.append(f"keyframeSelection from the AVI picked {kf['avi']['selected']} (rc {kf['avi']['rc']}), "
                   f"from its .npy frames {kf['npy']['selected']}")
    return bad


def codecs_summary(row: dict) -> dict:
    """The codecs row's headline numbers (the full row goes to a file)."""
    t, b, kf, pp = row["tiff_24mp"], row["bmp_24mp"], row["keyframes"], row["pipeline"]
    return {"fixtures": row["fixtures"]["fixtures"], "fixture_misses": len(row["fixtures"]["misses"]),
            "lzw_24mp": {k: t["lzw"][k] for k in ("decode_s", "decode_mp_s", "host_peak_gib", "equal_to_strip")},
            "deflate_24mp": {k: t["deflate"][k] for k in ("decode_s", "decode_mp_s", "host_peak_gib", "equal")},
            "bmp_24mp": {k: b[k] for k in ("write_s", "read_s", "read_mp_s", "equal")},
            "keyframes": {"avi_s": kf["avi"]["seconds"], "frames_per_s": kf["avi"]["frames_per_s"],
                          "npy_s": kf["npy"]["seconds"], "selected": kf["avi"]["selected"], "equal": kf["equal"]},
            "pipeline": {"focal_px": sorted(set(pp["camera_init_focal_px"])), "n_posed": pp["n_posed"],
                         "ate_frac_of_radius": pp["ate_frac_of_radius"],
                         "max_rotation_err_deg": max(pp["rotation_err_deg"]), "landmarks": pp["landmarks"],
                         "sgm_launches": pp["sgm_launches"], "seconds": sum(pp["stage_seconds"].values())},
            "seconds": row["seconds"], "misses": row["misses"]}


def run_codecs_phase(dev, work: str, image_folder: str, posed_sfm: str, gt: np.ndarray, smi: str = "",
                     avi_cfg=CODEC_AVI) -> tuple:
    """The codecs phase (see its constants): (the `codecs` row, the SGM
    launches of its pipeline run)."""
    t_phase = time.perf_counter()
    row = {"device": smi, "fixtures": check_codec_fixtures(), "tiff_24mp": tiff_24mp(work),
           "bmp_24mp": bmp_24mp(work)}
    row["pipeline"] = tiff_pipeline(dev, work, image_folder, posed_sfm, gt)
    launches = dict(row["pipeline"]["sgm_launches"])
    row["keyframes"] = avi_keyframes(dev, work, avi_cfg)
    row["seconds"] = time.perf_counter() - t_phase
    row["misses"] = codecs_misses(row)
    return row, launches


def check_codecs(dev, work: str, image_folder: str, posed_sfm: str, gt: np.ndarray, smi: str) -> tuple:
    row, launches = run_codecs_phase(dev, work, image_folder, posed_sfm, gt, smi)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "codecs_phase.json"), "w") as f:
        json.dump(row, f, indent=1)
    summary = codecs_summary(row)
    print("codecs " + json.dumps(summary), flush=True)
    if row["misses"]:
        raise RuntimeError("codecs: " + "; ".join(row["misses"]))
    return summary, launches


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


# --------------------------------------------------------- mesh_surface

# Checks of the mesh_surface phase: meshing_surface on the dense phase's
# D = 96 maps, filtered at the stage's default (3 consistent views), of the
# 8-view scene. The mesh must hold at least what the surface half of
# tests/test_pipeline_e2e.py asks (more than 500 faces, more than 300
# vertices, every face index valid). The rendered background is a flat 0.5,
# where SGM's costs tie, and some of its depths survive the filtering in
# both packages (a CPU run of the port at half this size: 49k background
# pixels beside 198k surface ones, 1.5 % of the mesh's vertices outside the
# box world, up to z = 2.8): so at least MESH_IN_BOX_FRAC of the vertices
# must lie within the box world's bounds (default_boxes) padded by
# MESH_BOX_MARGIN, and the median distance from a vertex to the box world's
# surface must be under MESH_MEDIAN_DIST scene units (ring radius 6; the
# D = 96 maps' median relative errors of 0.0016-0.0062 at depths of 4-8 are
# 0.01-0.05 units; the CPU run: 0.0147).
MESH_MIN_FACES, MESH_MIN_VERTS = 500, 300
MESH_BOX_MARGIN, MESH_IN_BOX_FRAC = 0.25, 0.95
MESH_MEDIAN_DIST = 0.05


def box_surface_distance(p: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Distance from each point (P, 3) to the nearest box face of the box
    world (N, 2, 3): outside a box the Euclidean distance to it, inside the
    distance to its nearest face."""
    q = p[:, None, :]
    lo, hi = boxes[None, :, 0], boxes[None, :, 1]
    outside = np.linalg.norm(np.maximum(np.maximum(lo - q, q - hi), 0.0), axis=-1)
    inside = np.minimum(q - lo, hi - q).min(-1)
    return np.where(outside > 0, outside, np.maximum(inside, 0.0)).min(1)


def run_mesh_surface(work: str, sfm: str, depth: str, device):
    """depthMapFiltering of the maps in `depth` and meshing_surface, both at
    the stages' defaults, writing under `work`, with the SGM launch counts
    set to 0 just before and read just after (the surface path launches
    none). Returns (vertices, faces, the stage's seconds by step, the
    filtering's seconds, the launches)."""
    filtered = os.path.join(work, "filtered_mesh")
    sgm_kernel.launches.update(dict.fromkeys(sgm_kernel.launches, 0))
    t0 = time.perf_counter()
    stages.depth_map_filtering(sfm, depth, filtered, device=device)
    filter_s = time.perf_counter() - t0
    seconds = {}
    verts, faces = stages.meshing_surface(sfm, filtered, os.path.join(work, "mesh.obj"), device=device,
                                          seconds=seconds)
    return verts, faces, seconds, filter_s, dict(sgm_kernel.launches)


def check_mesh_surface(dev, work: str, sfm: str, depth96: str) -> dict:
    """The mesh_surface phase on the dense phase's D = 96 maps."""
    from alicevision_tpu_torch.mesh import load_obj
    from alicevision_tpu_torch.utils.rendered import default_boxes

    verts, faces, seconds, filter_s, launches = run_mesh_surface(work, sfm, depth96, dev)
    boxes = default_boxes()
    lo, hi = boxes[:, 0].min(0) - MESH_BOX_MARGIN, boxes[:, 1].max(0) + MESH_BOX_MARGIN
    inside = ((verts >= lo) & (verts <= hi)).all(1)
    dist = box_surface_distance(verts.astype(np.float64), boxes)
    lv, lf = load_obj(os.path.join(work, "mesh.obj"))
    row = {
        "vertices": int(len(verts)), "faces": int(len(faces)),
        "faces_valid": bool(len(faces) and faces.min() >= 0 and faces.max() < len(verts)),
        "obj_round_trip": bool(len(lf) == len(faces) and len(lv) == len(verts)),
        "frac_in_box_world": float(inside.mean()),
        "median_dist_to_surface": float(np.median(dist)),
        "p90_dist_to_surface": float(np.percentile(dist, 90)),
        "filtering_s": filter_s, "stage_seconds": seconds, "stage_s": sum(seconds.values()),
        "sgm_launches": launches,
    }
    print("mesh_surface " + json.dumps(row), flush=True)
    bad = []
    if not (row["faces"] > MESH_MIN_FACES and row["vertices"] > MESH_MIN_VERTS and row["faces_valid"]
            and row["obj_round_trip"]):
        bad.append(f"{row['faces']} faces, {row['vertices']} vertices, indices valid {row['faces_valid']}, "
                   f"OBJ read back {row['obj_round_trip']}")
    if not inside.mean() >= MESH_IN_BOX_FRAC:
        bad.append(f"{inside.mean():.4f} of the vertices within the box world padded by {MESH_BOX_MARGIN}, "
                   f"expected at least {MESH_IN_BOX_FRAC}")
    if not row["median_dist_to_surface"] < MESH_MEDIAN_DIST:
        bad.append(f"median distance to the surface {row['median_dist_to_surface']:.4f}, "
                   f"expected below {MESH_MEDIAN_DIST}")
    if any(launches.values()):
        bad.append(f"SGM launches {launches}, expected none")
    if bad:
        raise RuntimeError("mesh_surface: " + "; ".join(bad))
    return row


# ----------------------------------------------------------- hard_scene

# Checks of the hard_scene phase (tests/test_hard_scene.py and
# tests/test_hard_scene_images.py, bench.py:698-849). The ground-truth
# projection path runs the engine at its defaults with robust
# triangulation on the 40-view matches, under the normal prior (focal 2 %
# off, zero K3) and the stressed one (10 % off, principal point at (20,
# -12) px); the images path renders the ring at the reference's operating
# point and runs the front end and the engine on the pixels.
HARD_VIEWS, HARD_POINTS = 40, 600
HARD_GATES = {
    "normal": dict(min_posed=38, ate=0.01, focal=0.01, k1=0.03, golden=0.02),
    "stressed": dict(min_posed=36, ate=0.015, focal=0.02, k1=0.06, pp=0.65),
}
HARD_PRIORS = {"normal": dict(focal=1.02, offset=(0.0, 0.0)), "stressed": dict(focal=1.10, offset=(20.0, -12.0))}
HARD_GOLDEN = os.path.join(ROOT, "tests", "golden", "hard_scene_poses.npz")
HARD_IMG = dict(wh=(1280, 960), focal_px=900.0, max_keypoints=10000, n_neighbors=6)
HARD_IMG_MIN_POSED, HARD_IMG_ATE = 39, 0.012
# The card's render against the host numpy render (render_hard_views_numpy)
# of two views at full size: within RENDER_ATOL on all but at most
# RENDER_MAX_FLIPPED of the pixels, tests/test_torch_hard_scene.py's bound
# (a texel boundary or a silhouette that float64 sums in another order put
# on the other side; the CPU run has none).
RENDER_CHECK_VIEWS = (0, 20)
RENDER_ATOL, RENDER_MAX_FLIPPED = 1e-6, 1e-3


def _ate_rel(est: np.ndarray, gt: np.ndarray, c_all: np.ndarray):
    """Camera-centre ATE after a similarity alignment, over the radius of
    the whole ring (bench.py's hard-scene measure), and the aligned
    centres."""
    s, R, t = _align_similarity(est, gt)
    aligned = est @ (s * R).T + t
    ate = float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))
    radius = float(np.linalg.norm(c_all - c_all.mean(0), axis=1).mean())
    return ate / radius, aligned


def _engine_rms_px(engine) -> float:
    """RMS reprojection error of the engine's final model, pixels."""
    m = engine._obs_table_mask()
    problem = engine._make_problem(m, cam_fixed=~engine.res.posed)
    return float(ba.rms_reprojection_error(problem, problem.cam_q, problem.cam_c, problem.points))


def run_hard_scene_engine(device, prior: str = "normal"):
    """tests/test_hard_scene.py's run through the port: hard_scene(40, 600)
    -> verified_matches_from_scene -> build_tracks -> IncrementalSfM with a
    RADIALK3 prior of zeros. Returns (the scene, the engine, its seconds)."""
    from alicevision_tpu_torch.sfm.incremental import IncrementalConfig, IncrementalSfM
    from alicevision_tpu_torch.tracks.builder import build_tracks
    from alicevision_tpu_torch.utils.rendered import hard_scene, verified_matches_from_scene

    hs = hard_scene(HARD_VIEWS, HARD_POINTS)
    pm, fxy, nf = verified_matches_from_scene(hs)
    tracks = build_tracks(pm, nf, min_track_length=2)
    w, h = hs.image_size
    pr = HARD_PRIORS[prior]
    intr = cam.make_intrinsics(w, h, float(hs.K[0, 0]) * pr["focal"], disto_kind=cam.DISTO_RADIALK3,
                               disto_params=(0.0, 0.0, 0.0), offset=pr["offset"])
    intr = cam.Intrinsics(*(x[None] for x in intr))
    engine = IncrementalSfM(tracks, fxy, intr, np.zeros(HARD_VIEWS, np.int32), np.tile([w, h], (HARD_VIEWS, 1)),
                            IncrementalConfig(robust_triangulation=True, seed=0), device=device)
    t0 = time.perf_counter()
    engine.process()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return hs, engine, time.perf_counter() - t0


def hard_scene_report(hs, engine, prior: str) -> tuple:
    """The engine's result against the truth and the prior's gates: (row,
    the gates it misses)."""
    res, intr = engine.res, engine.intr_np
    posed = np.nonzero(res.posed)[0]
    ate, _ = _ate_rel(res.pose_c[posed], hs.c[posed], hs.c)
    f, k1, pp = float(intr.scale[0, 0]), float(intr.disto[0, 0]), intr.offset[0].astype(np.float64)
    g = HARD_GATES[prior]
    row = {
        "posed": int(len(posed)), "ate_frac_of_radius": ate,
        "focal_px": intr.scale[0].tolist(), "focal_true": float(hs.K[0, 0]),
        "k1": k1, "k1_true": float(hs.disto[0]), "disto": intr.disto[0, :3].tolist(),
        "pp_offset_px": pp.tolist(), "landmarks": int(res.point_valid.sum()), "rms_px": _engine_rms_px(engine),
        "step_seconds": dict(engine.seconds),
    }
    bad = []
    if len(posed) < g["min_posed"]:
        bad.append(f"{len(posed)} of {HARD_VIEWS} posed, expected at least {g['min_posed']}")
    if not ate < g["ate"]:
        bad.append(f"ATE {ate:.5f} of the radius, expected below {g['ate']}")
    if not abs(f - hs.K[0, 0]) / hs.K[0, 0] < g["focal"]:
        bad.append(f"focal {f:.2f}, expected within {g['focal']:.0%} of {hs.K[0, 0]}")
    if not abs(k1 - hs.disto[0]) < g["k1"]:
        bad.append(f"k1 {k1:.4f}, expected within {g['k1']} of {hs.disto[0]}")
    if "pp" in g:
        prior_off = np.linalg.norm(HARD_PRIORS[prior]["offset"])
        if not np.linalg.norm(pp) < g["pp"] * prior_off:
            bad.append(f"principal point offset {pp}, expected within {g['pp']} x {prior_off:.1f} px")
    if "golden" in g:
        gold = np.load(HARD_GOLDEN)
        both = np.intersect1d(posed, gold["posed"])
        _, a = _ate_rel(res.pose_c[both], hs.c[both], hs.c)
        _, b = _ate_rel(gold["pose_c"][both], hs.c[both], hs.c)
        row["golden_max_drift"] = float(np.linalg.norm(a - b, axis=1).max())
        row["golden_views_compared"] = int(len(both))
        if not row["golden_max_drift"] < g["golden"]:
            bad.append(f"aligned centres {row['golden_max_drift']:.4f} from the golden run, expected < {g['golden']}")
    return row, bad


def hard_images_config(wh=HARD_IMG["wh"]):
    """The engine's configuration on the images path (bench.py:822-836):
    seed 0 and the outlier gate scaled with the image diagonal, 4 *
    hypot(W, H) / 800 px (8 px at 1280x960), where the reference's 4 px
    culls correct border matches of a zero-K3 prior."""
    from alicevision_tpu_torch.sfm.incremental import IncrementalConfig

    return IncrementalConfig(seed=0, max_reproj_px=4.0 * math.hypot(*wh) / 800.0)


def run_hard_images(work: str, device, wh=HARD_IMG["wh"], focal_px: float = HARD_IMG["focal_px"],
                    max_keypoints: int = HARD_IMG["max_keypoints"]):
    """bench.py's images path (bench.py:764-849) through the port's stages:
    render_hard_views on `device` -> .npy images -> cameraInit with the
    focal 2 % off -> featureExtraction (DSP-SIFT at full resolution,
    `max_keypoints`) -> voctree imageMatching -> featureMatching ->
    incrementalSfm with the resolution-scaled gate 4 * hypot(W, H) / 800
    px. `wh`, `focal_px` and `max_keypoints` are the reference's operating
    point; smaller ones rehearse the path on the CPU. Returns (the stage
    seconds, each stage's peak device memory in GiB, the output scene, the
    true centres)."""
    from alicevision_tpu_torch.utils.rendered import render_hard_views

    cuda = torch.device(device).type == "cuda"
    seconds, peak = {}, {}

    def timed(name, fn, *args, **kw):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        if cuda:
            torch.cuda.synchronize()
            peak[name] = torch.cuda.max_memory_allocated(device) / 2**30
        seconds[name] = time.perf_counter() - t0
        return res

    imgs, _, _, _, c_gt = timed("render", render_hard_views, HARD_VIEWS, wh, focal_px=focal_px, device=device)
    img_dir = os.path.join(work, "hard_images")
    os.makedirs(img_dir, exist_ok=True)
    t0 = time.perf_counter()
    for v in range(HARD_VIEWS):
        np.save(os.path.join(img_dir, f"view_{v:03d}.npy"), imgs[v])
    seconds["save_npy"] = time.perf_counter() - t0
    scene = os.path.join(work, "hard_cameraInit.sfm")
    feats = os.path.join(work, "hard_features")
    pairs = os.path.join(work, "hard_pairs.txt")
    matches = os.path.join(work, "hard_matches.npz")
    timed("cameraInit", stages.camera_init, img_dir, scene, default_focal_px=focal_px * 1.02, device=device)
    timed("featureExtraction", stages.feature_extraction, scene, feats, max_keypoints=max_keypoints,
          downscale_to=0, describer_types="dspsift", device=device)
    timed("imageMatching", stages.image_matching, scene, feats, pairs, method="voctree",
          n_neighbors=HARD_IMG["n_neighbors"], device=device)
    timed("featureMatching", stages.feature_matching, scene, feats, pairs, matches, device=device)
    out = timed("incrementalSfm", stages.incremental_sfm, scene, feats, matches,
                os.path.join(work, "hard_sfm.sfm"), config=hard_images_config(wh), device=device)
    return seconds, peak, out, c_gt


def compare_hard_render(img_dir: str, views=RENDER_CHECK_VIEWS) -> dict:
    """The images the card rendered into `img_dir` against the host numpy
    render of the same views: the share of pixels more than RENDER_ATOL
    apart, and the largest difference among the others."""
    from alicevision_tpu_torch.utils.rendered import render_hard_views_numpy

    t0 = time.perf_counter()
    plain = render_hard_views_numpy(HARD_VIEWS, HARD_IMG["wh"], focal_px=HARD_IMG["focal_px"], views=views)[0]
    card = np.stack([np.load(os.path.join(img_dir, f"view_{v:03d}.npy")) for v in views])
    diff = np.abs(card - plain)
    flipped = diff > RENDER_ATOL
    return {"views": list(views), "flipped_frac": float(flipped.mean()),
            "max_abs_diff_unflipped": float(diff[~flipped].max(initial=0.0)),
            "max_abs_diff": float(diff.max()), "host_render_s": time.perf_counter() - t0}


def check_hard_scene(dev, work: str, card: str) -> dict:
    """The hard_scene phase: the engine on the ground-truth-projection
    matches at the normal and the stressed prior, then the images path at
    the reference's operating point, each with the SGM launch counts set to
    0 just before and read just after (the SfM path launches none)."""
    row, bad = {"card": card}, []
    for prior in ("normal", "stressed"):
        sgm_kernel.launches.update(dict.fromkeys(sgm_kernel.launches, 0))
        torch.cuda.reset_peak_memory_stats(dev)
        hs, engine, sec = run_hard_scene_engine(dev, prior)
        rep, miss = hard_scene_report(hs, engine, prior)
        rep.update(engine_s=sec, peak_device_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                   sgm_launches=dict(sgm_kernel.launches))
        row[f"gt_projection_{prior}"] = rep
        print(f"hard_scene {prior} prior " + json.dumps(rep), flush=True)
        bad += [f"{prior} prior: {m}" for m in miss]
        del engine

    sgm_kernel.launches.update(dict.fromkeys(sgm_kernel.launches, 0))
    seconds, peak, out, c_gt = run_hard_images(work, dev)
    engine = stages.last_engine
    vp = out.view_pose
    posed = [v for v in range(HARD_VIEWS) if vp[v] >= 0]
    ate, _ = _ate_rel(np.stack([out.pose_c[vp[v]] for v in posed]), c_gt[posed], c_gt)
    feats = os.path.join(work, "hard_features")
    img = {
        "wh": list(HARD_IMG["wh"]), "max_keypoints": HARD_IMG["max_keypoints"],
        "posed": len(posed), "ate_frac_of_radius": ate,
        "focal_px": out.scale[0].tolist(), "focal_true": HARD_IMG["focal_px"],
        "k1": float(out.disto[0][0]), "k1_true": -0.25,
        "rms_px": _engine_rms_px(engine),
        "keypoints_per_view": [int(stages.load_features(feats, int(i))["valid"].sum()) for i in out.view_ids],
        "pairs": int(len(stages.load_pairs(os.path.join(work, "hard_pairs.txt")))),
        "inliers_total": int(sum(len(m) for m in stages.load_matches(os.path.join(work, "hard_matches.npz")).values())),
        "tracks": int(engine.T), "landmarks": int(engine.res.point_valid.sum()),
        "stage_seconds": seconds, "stage_peak_device_gib": peak,
        "engine_step_seconds": dict(engine.seconds),
        "sgm_launches": dict(sgm_kernel.launches),
        "render_vs_host": compare_hard_render(os.path.join(work, "hard_images")),
    }
    row["images"] = img
    print("hard_scene images " + json.dumps(img), flush=True)
    if len(posed) < HARD_IMG_MIN_POSED:
        bad.append(f"images path: {len(posed)} of {HARD_VIEWS} posed, expected at least {HARD_IMG_MIN_POSED}")
    if not ate < HARD_IMG_ATE:
        bad.append(f"images path: ATE {ate:.5f} of the radius, expected below {HARD_IMG_ATE}")
    if not img["render_vs_host"]["flipped_frac"] <= RENDER_MAX_FLIPPED:
        bad.append(f"the card's render against the host's: {img['render_vs_host']}")
    runs = [img] + [row[f"gt_projection_{p}"] for p in HARD_PRIORS]
    if any(n for r in runs for n in r["sgm_launches"].values()):
        bad.append("the SfM path launched the SGM kernel")
    if bad:
        raise RuntimeError("hard_scene: " + "; ".join(bad))
    return row


# ------------------------------------------------------------------ cli

# The cli phase: Meshroom's chain as one `python -m
# alicevision_tpu_torch.pipeline.cli` process a stage, at the CLI's own
# defaults (DSP-SIFT, D = 96 at 640x480, a 2048^2 multi-band atlas). Its
# gates are the pipeline phase's (poses, D = 96 depth floors), the
# mesh_surface phase's size and index checks, the surface mesh's agreement
# with the maps it was fused from, and the share of the atlas's charts that
# texturing coloured. Two gates of the earlier phases do not hold for the reference
# itself on this chain: DSP-SIFT's keypoints move the short arc's
# intrinsics, and on the card's own features (saved by
# scripts/cli_chain_diagnostics_torch.py) the JAX engine misses the pipeline
# phase's 1 deg of rotation error and its dense and mesh stages miss the
# mesh_surface phase's box-world gates (scripts/cli_chain_reference.py, on
# the CPU; PERF.md §6). Those two gates are replaced by the reference's
# numbers with a margin: the rotation gate lies above every reading of
# either engine on those features (the port's on the CPU the largest), the
# box-world gates below the JAX chain's share of vertices in the box and
# above its median distance to the boxes.
CLI_ATLAS = 2048
# Texturing is read on its charts' own texels (`atlas_fills`): of the texels
# inside the faces' UV triangles, the share the views coloured. The share
# of the whole atlas, gated at 5 % before (tests/test_pipeline_e2e.py's
# floor), counts charts packed at a fixed texel density, so it follows the
# mesh's area, junk faces included: it read 6.06-6.15 % while F and H were
# float32 on the card and 4.40-7.95 % once they were float64 and the mesh
# lost junk (the cli surface mesh's vertices in the box world 0.645-0.661
# before, 0.813-0.826 after; PERF.md §6). The mesh's junk has its own gates
# (CLI_BOX_IN_FRAC, CLI_BOX_MEDIAN). Two saved meshes of the card's chain,
# textured from their views and depth maps by the JAX package and by the
# port (scripts/cli_atlas_fill_reference.py --inputs, CPU), read alike in
# both: whole-atlas fill 5.13 % and 4.43 % (under the old gate in both
# packages), charts' texels coloured 0.99589 and 0.99614. The gate leaves
# five times the uncoloured share for faces that no view sees.
CLI_MIN_FOOTPRINT_FILL = 0.98
CLI_ROT_DEG = 2.0
CLI_BOX_IN_FRAC, CLI_BOX_MEDIAN = 0.55, 0.30
CLI_MESH_MAPS_MED = 0.02  # the mesh against its input maps, median relative difference a view
CLI_FOCAL_PX = 1120.0  # cameraInit's --defaultFocalPx, as the pipeline phase
CLI_DOWNSCALE = 2  # the dense stages' --downscale default


def cli_chain(work: str, image_folder: str, extra=()) -> list:
    """The 14 stage commands of the cli phase, as (name, argv) over `work`:
    cameraInit -> featureExtraction -> imageMatching -> featureMatching ->
    incrementalSfm -> prepareDenseScene -> depthMapEstimation ->
    depthMapFiltering -> meshSurface -> meshFiltering -> texturing, then
    tracksBuilding -> sfmBootstraping -> sfmExpanding on the same features
    and matches. `extra` is appended to every command (e.g. --device)."""
    def w(*p):
        return os.path.join(work, *p)

    init, sfm = w("cameraInit.sfm"), w("sfm.sfm")
    steps = [
        ("cameraInit", ["--imageFolder", image_folder, "--output", init, "--defaultFocalPx", str(CLI_FOCAL_PX)]),
        ("featureExtraction", ["--input", init, "--output", w("features")]),
        ("imageMatching", ["--input", init, "--features", w("features"), "--output", w("pairs.txt")]),
        ("featureMatching", ["--input", init, "--features", w("features"), "--pairs", w("pairs.txt"),
                             "--output", w("matches.npz")]),
        ("incrementalSfm", ["--input", init, "--features", w("features"), "--matches", w("matches.npz"),
                            "--output", sfm]),
        ("prepareDenseScene", ["--input", sfm, "--output", w("dense")]),
        ("depthMapEstimation", ["--input", sfm, "--images", w("dense"), "--output", w("depth")]),
        ("depthMapFiltering", ["--input", sfm, "--depth", w("depth"), "--output", w("depth_filtered")]),
        ("meshSurface", ["--input", sfm, "--depth", w("depth_filtered"), "--output", w("mesh.obj")]),
        ("meshFiltering", ["--input", w("mesh.obj"), "--output", w("mesh_filtered.obj"), "--clean",
                           "--fillHolesMaxEdges", "8"]),
        ("texturing", ["--input", sfm, "--mesh", w("mesh_filtered.obj"), "--images", w("dense"), "--depth",
                       w("depth"), "--output", w("textured.obj"), "--atlasSize", str(CLI_ATLAS)]),
        ("tracksBuilding", ["--input", init, "--features", w("features"), "--matches", w("matches.npz"),
                            "--output", w("tracks.npz")]),
        ("sfmBootstraping", ["--input", init, "--features", w("features"), "--tracks", w("tracks.npz"),
                             "--output", w("bootstrap.sfm")]),
        ("sfmExpanding", ["--input", w("bootstrap.sfm"), "--features", w("features"), "--tracks",
                          w("tracks.npz"), "--output", w("expanded.sfm")]),
    ]
    return [(name, [name, *argv, *extra]) for name, argv in steps]


def _resident_bytes(pid: int):
    """The resident memory of process `pid` (/proc/<pid>/statm), or None
    once it has gone."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return None


def run_cli_process(argv: list, log_prefix: str) -> dict:
    """One `python -m alicevision_tpu_torch.pipeline.cli` process from
    launch to exit: its seconds, exit code, the stage's own seconds and
    device peak memory (from its "done" line), its host peak (its resident
    memory sampled every 10 ms while it runs: a peak shorter than that may
    be missed), and its stdout. stdout and stderr go to `log_prefix`.out /
    .err."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    peak = 0
    with open(log_prefix + ".out", "w") as out, open(log_prefix + ".err", "w") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "alicevision_tpu_torch.pipeline.cli", *argv],
                                cwd=ROOT, env=env, stdout=out, stderr=err)
        while proc.poll() is None:
            peak = max(peak, _resident_bytes(proc.pid) or 0)
            time.sleep(0.01)
        rc = proc.returncode
        seconds = time.perf_counter() - t0
    with open(log_prefix + ".err") as f:
        err_text = f.read()
    with open(log_prefix + ".out") as f:
        out_text = f.read()

    def last(pattern):
        found = re.findall(pattern, err_text)
        return float(found[-1]) if found else None

    return {"seconds": seconds, "rc": rc, "stage_s": last(r"done in ([0-9.]+)s"),
            "host_peak_gib": peak / 2**30 if peak else None,
            "device_peak_gib": last(r"peak device memory ([0-9.]+) GiB"), "stdout": out_text, "stderr": err_text}


def mesh_box_stats(verts: np.ndarray, faces: np.ndarray) -> dict:
    """The mesh_surface phase's statistics of a mesh in the rendered frame."""
    from alicevision_tpu_torch.utils.rendered import default_boxes

    boxes = default_boxes()
    lo, hi = boxes[:, 0].min(0) - MESH_BOX_MARGIN, boxes[:, 1].max(0) + MESH_BOX_MARGIN
    dist = box_surface_distance(verts.astype(np.float64), boxes)
    return {
        "vertices": int(len(verts)), "faces": int(len(faces)),
        "faces_valid": bool(len(faces) and faces.min() >= 0 and faces.max() < len(verts)),
        "frac_in_box_world": float(((verts >= lo) & (verts <= hi)).all(1).mean()),
        "median_dist_to_surface": float(np.median(dist)),
        "p90_dist_to_surface": float(np.percentile(dist, 90)),
    }


def mesh_view_agreement(sfm_path: str, mesh_path: str, depth_folder: str, gt: np.ndarray, scale: float,
                        device) -> dict:
    """The mesh rendered into each posed view of the scene at the stage
    scale (`mesh/render.py` on `device`): per view the median relative
    difference to the view's depth map in `depth_folder` where both have a
    depth (the mesh against the maps it was fused from), and the median
    relative error of the rendered depth times `scale` against the rendered
    truth (`depth_stats`)."""
    from alicevision_tpu_torch.mesh import load_obj
    from alicevision_tpu_torch.mesh.render import render_depth_map

    sc = sfmdata.load(sfm_path)
    V, F = load_obj(mesh_path)
    vs_maps, vs_truth = [], []
    for v in sc.valid_views():
        K, R, c = sc.camera_matrices(v)
        K = K.copy()
        K[:2] /= CLI_DOWNSCALE
        gt_v = gt[v, ::CLI_DOWNSCALE, ::CLI_DOWNSCALE]
        d, _ = render_depth_map(V, F, K, R, c, gt_v.shape, device=device)
        m = np.load(os.path.join(depth_folder, f"{int(sc.view_ids[v])}_depth.npy"))
        both = (d > 0) & (m > 0)
        vs_maps.append(float(np.median(np.abs(d - m)[both] / m[both])) if both.any() else float("inf"))
        vs_truth.append(depth_stats(d * scale, gt_v)[0])
    return {"median_rel_diff_to_maps": vs_maps, "median_rel_err_to_truth": vs_truth}


def _degenerate_faces(v: np.ndarray, f: np.ndarray) -> int:
    area2 = np.linalg.norm(np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]), axis=1)
    repeated = (f[:, 0] == f[:, 1]) | (f[:, 1] == f[:, 2]) | (f[:, 0] == f[:, 2])
    return int((repeated | (area2 <= 0)).sum())


def atlas_fills(textured_obj: str) -> dict:
    """A textured OBJ's atlas (`<name>_atlas.png`) read two ways:
    "atlas_fill", the share of all its texels above 0, which follows the
    mesh's area (charts are packed at a fixed texel density, junk faces
    included); "footprint_fill", the share above 0 of the texels inside the
    faces' UV triangles (`uv_atlas.rasterize_geometry`'s face ids), the
    part of the charts that the views coloured."""
    from alicevision_tpu_torch.image.io import read_image
    from alicevision_tpu_torch.mesh.uv_atlas import rasterize_geometry

    V, VT, F, FT = [], [], [], []
    with open(textured_obj) as f:
        for line in f:
            head, _, rest = line.partition(" ")
            if head == "v":
                V.append([float(x) for x in rest.split()])
            elif head == "vt":
                VT.append([float(x) for x in rest.split()])
            elif head == "f":
                corners = [c.split("/") for c in rest.split()]
                F.append([int(c[0]) - 1 for c in corners])
                FT.append([int(c[1]) - 1 for c in corners])
    atlas = read_image(textured_obj[:-len(".obj")] + "_atlas.png", grayscale=True)
    vt = np.asarray(VT, np.float64)
    uvs = np.stack([vt[:, 0], 1.0 - vt[:, 1]], -1)[np.asarray(FT)]  # the OBJ's v is flipped
    _, fid = rasterize_geometry(np.asarray(V, np.float64), np.asarray(F), uvs, atlas.shape[0])
    inside = fid >= 0
    return {"atlas_fill": float((atlas > 0).mean()), "footprint_texels": int(inside.sum()),
            "footprint_fill": float((atlas[inside] > 0).mean()) if inside.any() else 0.0}


def _posed_ate(sfm_path: str, R_true: np.ndarray, c_true: np.ndarray) -> dict:
    """Posed views and camera-centre ATE (fraction of the ring radius) of a
    scene against the rendered poses (view v is image v + 1)."""
    sc = sfmdata.load(sfm_path)
    posed = sc.valid_views()
    est = sc.pose_c[sc.view_pose[posed]]
    s, Ra, t = _align_similarity(est, c_true[posed])
    ate = float(np.sqrt(np.mean(np.sum((est @ (s * Ra).T + t - c_true[posed]) ** 2, axis=1))))
    radius = float(np.linalg.norm(c_true[:, :2], axis=1).mean())
    return {"n_posed": int(len(posed)), "landmarks": int(sc.n_landmarks), "ate_frac_of_radius": ate / radius,
            "alignment": (s, Ra, t)}


def check_cli(dev, work: str, image_folder: str, posed_sfm: str, gt: np.ndarray, smi: str = "") -> tuple:
    """The cli phase: the 14 stage processes of `cli_chain` on the rendered
    images, each timed from launch to exit; depthMapEstimation once more
    in this process through `cli.main`, with its SGM launches counted and
    its maps held equal to the subprocess's; then the gates. Returns (the
    `cli` row, the in-process run's launches)."""
    from alicevision_tpu_torch.image.io import read_image
    from alicevision_tpu_torch.mesh import load_obj
    from alicevision_tpu_torch.pipeline import cli

    out = os.path.join(work, "cli")
    logs = os.path.join(work, "cli_logs")
    os.makedirs(out, exist_ok=True)
    os.makedirs(logs, exist_ok=True)
    extra = ["--device", str(dev)]
    seconds, rows = {}, {}
    for name, argv in cli_chain(out, image_folder, extra=extra):
        res = run_cli_process(argv, os.path.join(logs, name))
        if res["rc"] != 0:
            raise RuntimeError(f"cli: `{' '.join(argv)}` exited {res['rc']}: {res['stderr'][-2000:]}")
        seconds[name] = res["seconds"]
        rows[name] = {k: res[k] for k in ("seconds", "stage_s", "host_peak_gib", "device_peak_gib")}
        print(f"cli {name}: {res['seconds']:.2f} s ({res['stage_s']} s in the stage), host peak "
              f"{res['host_peak_gib']} GiB, device peak {res['device_peak_gib']} GiB", flush=True)
        if name == "texturing":
            texturing_steps = json.loads(res["stdout"].strip().splitlines()[-1])["texturing_seconds"]

    # depthMapEstimation again in this process, with the kernel's launches
    sfm = os.path.join(out, "sfm.sfm")
    again = os.path.join(out, "depth_inprocess")
    sgm_kernel.launches.update(dict.fromkeys(sgm_kernel.launches, 0))
    t0 = time.perf_counter()
    rc = cli.main(["depthMapEstimation", "--input", sfm, "--images", os.path.join(out, "dense"),
                   "--output", again, "--profile", os.path.join(logs, "profile"), *extra])
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    inproc_s = time.perf_counter() - t0
    launches = dict(sgm_kernel.launches)
    traces = sorted(os.listdir(os.path.join(logs, "profile")))
    with open(os.path.join(logs, "profile", traces[-1])) as f:
        events = json.load(f)["traceEvents"]
    trace = {"events": len(events), "device_kernels": sum(e.get("cat") == "kernel" for e in events),
             "sgm_kernels": sum(e.get("cat") == "kernel" and "sgm" in e.get("name", "") for e in events)}
    names = sorted(f for f in os.listdir(os.path.join(out, "depth")) if f.endswith("_depth.npy"))
    diff = max(float(np.abs(np.load(os.path.join(out, "depth", f)) - np.load(os.path.join(again, f))).max())
               for f in names)
    equal = all(np.array_equal(np.load(os.path.join(out, "depth", f)), np.load(os.path.join(again, f)))
                for f in names)

    truth = sfmdata.load(posed_sfm)
    R_true, c_true = truth.pose_R[truth.view_pose], truth.pose_c[truth.view_pose]
    rep = pipeline_report(out, R_true, c_true, gt)
    s, Ra, t = _posed_ate(sfm, R_true, c_true)["alignment"]
    mv, mf = load_obj(os.path.join(out, "mesh.obj"))
    surface = mesh_box_stats(mv @ (s * Ra).T + t, mf)
    surface.update(mesh_view_agreement(sfm, os.path.join(out, "mesh.obj"), os.path.join(out, "depth_filtered"),
                                       gt, s, dev))
    fv, ff = load_obj(os.path.join(out, "mesh_filtered.obj"))
    filtered = {"vertices": int(len(fv)), "faces": int(len(ff)),
                "faces_valid": bool(len(ff) and ff.min() >= 0 and ff.max() < len(fv)),
                "degenerate_faces": _degenerate_faces(fv, ff)}
    with open(os.path.join(out, "textured.obj")) as f:
        obj = f.read()
    atlas = read_image(os.path.join(out, "textured_atlas.png"), grayscale=True)
    expanded = _posed_ate(os.path.join(out, "expanded.sfm"), R_true, c_true)
    boot = sfmdata.load(os.path.join(out, "bootstrap.sfm"))
    row = {
        "device": smi,
        "stage_process_seconds": seconds,
        "stages": rows,
        "total_process_seconds": sum(seconds.values()),
        "total_stage_seconds": sum(r["stage_s"] for r in rows.values()),
        "texturing_step_seconds": texturing_steps,
        "inprocess_depthMapEstimation_s": inproc_s,
        "inprocess_rc": rc,
        "inprocess_sgm_launches": launches,
        "inprocess_maps": len(names),
        "inprocess_max_abs_diff": diff,
        "inprocess_maps_equal": equal,
        "inprocess_profile_trace": trace,
        "incremental": {k: rep[k] for k in ("n_posed", "landmarks", "ate_frac_of_radius", "rotation_err_deg",
                                            "depth_median_rel_err", "depth_valid_frac", "focal_px")},
        "surface_mesh": surface,
        "filtered_mesh": filtered,
        "textured": {"vt_lines": obj.count("\nvt "), "usemtl": "usemtl" in obj,
                     "atlas_shape": list(atlas.shape), **atlas_fills(os.path.join(out, "textured.obj"))},
        "bootstrap": {"n_posed": int(len(boot.valid_views())), "landmarks": int(boot.n_landmarks)},
        "expanded": {k: v for k, v in expanded.items() if k != "alignment"},
    }
    print("cli " + json.dumps(row), flush=True)

    bad = []
    on_card = torch.device(dev).type == "cuda"
    want = {"sgm_directional_pass": 0, "sgm_axis_sweeps": LAUNCHES_PER_MAP * len(names) * on_card}
    if rc != 0 or launches != want or len(names) != rep["n_posed"]:
        bad.append(f"in-process depthMapEstimation: rc {rc}, {len(names)} maps, launches {launches}, "
                   f"expected {want}")
    if not equal:
        bad.append(f"in-process maps differ from the subprocess's by up to {diff}")
    if on_card and not trace["device_kernels"]:
        bad.append(f"the --profile trace holds no kernel of the card: {trace}")
    if rep["n_posed"] < PIPE_MIN_POSED or not rep["ate_frac_of_radius"] < PIPE_ATE_FRAC:
        bad.append(f"incrementalSfm: {rep['n_posed']} posed, ATE {rep['ate_frac_of_radius']:.4f} of the radius")
    if not max(rep["rotation_err_deg"]) < CLI_ROT_DEG:
        bad.append(f"incrementalSfm: rotation errors {rep['rotation_err_deg']} deg, expected < {CLI_ROT_DEG}")
    missed = [v for v, m, f in zip(rep["posed"], rep["depth_median_rel_err"], rep["depth_valid_frac"])
              if not (m < PIPE_DEPTH_MED and f > PIPE_DEPTH_VALID)]
    if missed:
        bad.append(f"views {missed} miss the depth floors (<{PIPE_DEPTH_MED}, >{PIPE_DEPTH_VALID})")
    if not (surface["faces"] > MESH_MIN_FACES and surface["vertices"] > MESH_MIN_VERTS and surface["faces_valid"]
            and surface["frac_in_box_world"] >= CLI_BOX_IN_FRAC and surface["median_dist_to_surface"] < CLI_BOX_MEDIAN
            and max(surface["median_rel_diff_to_maps"]) < CLI_MESH_MAPS_MED):
        bad.append(f"surface mesh: {surface}, expected more than {MESH_MIN_FACES} faces and {MESH_MIN_VERTS} "
                   f"vertices, valid indices, >= {CLI_BOX_IN_FRAC} of its vertices in the box world, a median "
                   f"distance to the boxes < {CLI_BOX_MEDIAN} and within {CLI_MESH_MAPS_MED} of its maps in "
                   f"every view")
    if not (filtered["faces"] > 0 and filtered["faces_valid"] and filtered["degenerate_faces"] == 0):
        bad.append(f"filtered mesh: {filtered}")
    tex = row["textured"]
    if not (tex["vt_lines"] > 0 and tex["usemtl"] and tex["atlas_shape"] == [CLI_ATLAS, CLI_ATLAS]
            and tex["footprint_fill"] >= CLI_MIN_FOOTPRINT_FILL):
        bad.append(f"texturing: {tex}, expected vt and usemtl lines and a {CLI_ATLAS}^2 atlas coloured on at "
                   f"least {CLI_MIN_FOOTPRINT_FILL} of its charts' texels")
    if expanded["n_posed"] < PIPE_MIN_POSED or not expanded["ate_frac_of_radius"] < PIPE_ATE_FRAC:
        bad.append(f"sfmExpanding: {expanded['n_posed']} posed, ATE {expanded['ate_frac_of_radius']:.4f}")
    if bad:
        raise RuntimeError("cli: " + "; ".join(bad))
    return row, launches


# The panorama phase: Meshroom's HDR panorama chain through the CLI, in
# this process (`cli.main`, no process start-up), on a procedural
# high-dynamic-range equirect: ldrToHdrSampling -> ldrToHdrCalibration (the
# three methods) on view 0, ldrToHdrMerge of every view with the Laguerre
# response, cameraInit -> featureExtraction -> imageMatching ->
# featureMatching at the CLI's defaults, panoramaEstimation and nodalSfM,
# panoramaWarping -> panoramaSeams -> panoramaMerging --seams ->
# panoramaCompositing -> panoramaPostProcessing; panoramaPrepareImages,
# panoramaInit, split360Images and imageProcessing on the side; the warp and
# composite again at a width of 8192; then relativePoseEstimating and
# globalSfM on the cli phase's features. The inputs are cut from a real
# shoot (24 MP frames, 3-5 brackets) to 12 views of 1024^2 with 3 brackets.
# The gates are the JAX chain's readings on the same inputs with a margin
# (scripts/panorama_chain_reference.py on the CPU; PERF.md §6).
PANO_GT_WH = (2048, 1024)  # the ground-truth equirect radiance
PANO_N_VIEWS, PANO_FOV_DEG, PANO_VIEW_PX = 12, 80.0, 1024  # 30 deg apart
PANO_EXPOSURES = (1.0, 4.0, 16.0)  # the reference's 4**i ladder of a folder
PANO_PHI = 0.3  # the brackets' Laguerre response
PANO_WIDTH, PANO_WIDTH_LARGE = 2048, 8192
PANO_SEED = 0
# The chain warps with the rotations of the sequential pairs: on the CLI's
# default exhaustive pairs, the 42 of 66 pairs that see no overlap each
# bring a random rotation, which the L2 averaging weights like the rest,
# in both packages (ROADMAP §3)
PANO_WARP_FROM = "panorama_seq.sfm"
# The gates, from the JAX chain on the same inputs (scripts/
# panorama_chain_reference.py, on the CPU): phi 0.30000001; merged
# correlations >= 0.998; rotations on the sequential pairs <= 0.043 deg;
# on the default exhaustive pairs, the 24 pairs whose views overlap
# estimate their relative rotations before the averaging within 0.057 deg
# of the truth (the port's engine on the CPU, on the JAX chain's matches:
# 0.060); the averaging, which the pairs without overlap break, reads up
# to 176.9 deg, so that run's averaged rotations are reported, not gated;
# panorama median relative errors 0.0238 (0.0148 with the seams) at 2048
# and 0.0130 at 8192;
# globalSfM on the cli phase's 8 views 8/8 posed, rotations <= 2.61 deg
# (the port's engine on the same CPU features 3.45, the largest reading)
# and ATE 2.37 % of the radius (the port's 2.49 %).
PANO_PHI_ERR = 1e-3
PANO_MIN_CORR = 0.95  # merged radiance against the truth (tests/test_hdr.py)
PANO_ROT_DEG = 0.1  # the averaged rotations of the sequential pairs
PANO_OVERLAP_PAIRS, PANO_PAIR_DEG = 24, 0.1  # the exhaustive run's overlapping pairs, before the averaging
PANO_MED_ERR = {PANO_WIDTH: 0.05, PANO_WIDTH_LARGE: 0.03}  # median relative error where covered
GLOBAL_ROT_DEG, GLOBAL_ATE_FRAC = 4.5, 0.035


def panorama_radiance() -> np.ndarray:
    """The phase's ground-truth equirect radiance, (H, W) float32: smoothed
    noise at three scales (wrapped in longitude), exponentiated to span
    ~0.003-3 around a median of 0.08, so that each of the three exposures
    clips a different part of the scene and the shortest one all but
    0.3 % of it."""
    import scipy.ndimage as ndi

    W, H = PANO_GT_WH
    rng = np.random.RandomState(PANO_SEED)
    n = np.zeros((H, W))
    for sigma, weight in ((W / 80.0, 0.75), (W / 320.0, 0.5), (W / 1280.0, 0.3)):
        layer = ndi.gaussian_filter(rng.randn(H, W), sigma, mode=("nearest", "wrap"))
        n += weight * layer / layer.std()
    n /= n.std()
    return (0.08 * np.exp(0.9 * n)).astype(np.float32)


def make_panorama_inputs(work: str, device) -> dict:
    """The phase's inputs in `work`: the ground-truth radiance (gt.npy), its
    PANO_N_VIEWS pinhole views split on `device` (the port's split_equirect),
    and 3 brackets a view through the Laguerre curve, clipped to [0, 1], as
    .npy in one folder a view (brackets/view_XX/b{0,1,2}.npy, so that the
    reference's exposure ladder 4**i is each folder's own). Returns the
    truth: radiance, views, K, world->camera rotations, focal."""
    from alicevision_tpu_torch.hdr import laguerre_apply
    from alicevision_tpu_torch.image.processing import split_equirect

    gt = panorama_radiance()
    os.makedirs(work, exist_ok=True)
    np.save(os.path.join(work, "gt.npy"), gt)
    views, K, R = split_equirect(torch.as_tensor(gt, device=device), n_splits=PANO_N_VIEWS, fov_deg=PANO_FOV_DEG,
                                 out_size=PANO_VIEW_PX)
    for v in range(PANO_N_VIEWS):
        folder = os.path.join(work, "brackets", f"view_{v:02d}")
        os.makedirs(folder, exist_ok=True)
        for b, t in enumerate(PANO_EXPOSURES):
            ldr = laguerre_apply(PANO_PHI, torch.clamp(views[v] * t, 0.0, 1.0))
            np.save(os.path.join(folder, f"b{b}.npy"), ldr.cpu().numpy())
    return {"gt": gt, "views": views.cpu().numpy(), "K": K.cpu().numpy(), "R": R,
            "focal_px": float(K[0, 0])}


def panorama_chain(work: str, focal_px: float) -> list:
    """The chain's commands over `work`, as (name, argv): the HDR trio (the
    calibration by each method on view 0), one merge a view, the front
    stages at the CLI's defaults, the rotation engines, the warp, seams,
    merge, composite and post-processing, and the side commands."""
    def w(*p):
        return os.path.join(work, *p)

    b0 = w("brackets", "view_00")
    steps = [("ldrToHdrSampling", ["--inputFolder", b0, "--output", w("hdr", "samples.npz")])]
    for m in ("laguerre", "grossberg", "debevec"):
        steps.append(("ldrToHdrCalibration", ["--input", w("hdr", "samples.npz"), "--output",
                                              w("hdr", f"response_{m}.npz"), "--calibrationMethod", m]))
    for v in range(PANO_N_VIEWS):
        steps.append(("ldrToHdrMerge", ["--inputFolder", w("brackets", f"view_{v:02d}"), "--output",
                                        w("merged", f"view_{v:02d}.npy"), "--response",
                                        w("hdr", "response_laguerre.npz")]))
    init = w("cameraInit.sfm")
    feats, matches = w("features"), w("matches.npz")
    steps += [
        ("cameraInit", ["--imageFolder", w("merged"), "--output", init, "--defaultFocalPx", repr(focal_px)]),
        ("featureExtraction", ["--input", init, "--output", feats]),
        ("imageMatching", ["--input", init, "--features", feats, "--output", w("pairs.txt")]),
        ("featureMatching", ["--input", init, "--features", feats, "--pairs", w("pairs.txt"), "--output", matches]),
        ("panoramaEstimation", ["--input", init, "--features", feats, "--matches", matches, "--output",
                                w("panorama.sfm")]),
        ("nodalSfM", ["--input", init, "--features", feats, "--matches", matches, "--output", w("nodal.sfm")]),
        # the ring's neighbours only: (i, i+1) and (i, i+2)
        ("imageMatching", ["--input", init, "--features", feats, "--output", w("pairs_seq.txt"), "--method",
                           "sequential", "--nbNeighbors", "2"]),
        ("featureMatching", ["--input", init, "--features", feats, "--pairs", w("pairs_seq.txt"), "--output",
                             w("matches_seq.npz")]),
        ("panoramaEstimation", ["--input", init, "--features", feats, "--matches", w("matches_seq.npz"),
                                "--output", w("panorama_seq.sfm")]),
        ("panoramaWarping", ["--input", w(PANO_WARP_FROM), "--output", w("warped"), "--panoWidth", str(PANO_WIDTH)]),
        ("panoramaSeams", ["--input", w("warped"), "--output", w("seams.npz")]),
        ("panoramaMerging", ["--input", w("warped"), "--seams", w("seams.npz"), "--output", w("pano_seams.npy")]),
        ("panoramaCompositing", ["--input", w("warped"), "--output", w("pano.npy")]),
        ("panoramaPostProcessing", ["--input", w("pano.npy"), "--output", w("pano_post.npy"), "--fillHoles",
                                    "--crop"]),
        ("panoramaPrepareImages", ["--inputFolder", b0, "--output", w("prepared")]),
        ("panoramaInit", ["--imageFolder", w("merged"), "--output", w("pano_init.sfm"), "--defaultFocalPx",
                          repr(focal_px)]),
        ("split360Images", ["--input", w("gt.npy"), "--output", w("split"), "--nbSplits", str(PANO_N_VIEWS), "--fov",
                            repr(PANO_FOV_DEG), "--outSize", "256"]),
        ("imageProcessing", ["--input", os.path.join(b0, "b1.npy"), "--output", w("processed.npy"), "--scale",
                             "0.5", "--sharpen", "0.5", "--contrast", "1.2"]),
    ]
    return steps


def run_chain(main, chain: list, phase: str, extra=(), device=None, after=None) -> dict:
    """Each (subcommand, argv) of `chain` through `main` (a CLI's `main`),
    timed to the end of its device work, with its device peak on a card;
    `after(name, row)` runs after each command. Returns {name (#k for a
    repeated one): {"seconds", "device_peak_gib", ...}}; raises at the
    first command that fails, naming `phase`."""
    on_card = device is not None and torch.device(device).type == "cuda"
    rows, seen = {}, {}
    for name, argv in chain:
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        rc = main([name, *argv, *extra])
        if on_card:
            torch.cuda.synchronize(device)
        if rc != 0:
            raise RuntimeError(f"{phase}: `{name} {' '.join(argv)}` exited {rc}")
        k = seen[name] = seen.get(name, 0) + 1
        row = rows[name if k == 1 else f"{name}#{k}"] = {
            "seconds": time.perf_counter() - t0,
            "device_peak_gib": torch.cuda.max_memory_allocated(device) / 2**30 if on_card else None}
        if after is not None:
            after(name, row)
    return rows


def run_panorama_chain(main, work: str, inputs: dict, extra=(), device=None) -> dict:
    """`run_chain` of `panorama_chain`."""
    return run_chain(main, panorama_chain(work, inputs["focal_px"]), "panorama", extra, device)


def _gt_on_canvas(gt: np.ndarray, width: int) -> np.ndarray:
    """The ground-truth equirect resampled onto a canvas of `width` x
    width / 2 (pixel u of either maps to longitude (u / W - 0.5) 2 pi)."""
    H, W = gt.shape
    if width == W:
        return gt
    from alicevision_tpu_torch.image.filtering import bilinear_sample

    s = W / width
    ys, xs = np.meshgrid(np.arange(width // 2) * s, np.arange(width) * s, indexing="ij")
    uv = torch.as_tensor(np.stack([xs, ys], -1), dtype=torch.float32)
    return bilinear_sample(torch.as_tensor(gt), uv).numpy()


def panorama_error(pano: np.ndarray, gt: np.ndarray, covered: np.ndarray) -> float:
    """Median relative error of a panorama against the truth where it is
    covered (away from the canvas's last column and row, where the truth's
    bilinear resampling has no right or lower neighbour)."""
    ref = _gt_on_canvas(gt, pano.shape[1])
    ok = covered.copy()
    ok[-2:], ok[:, -2:] = False, False
    return float(np.median(np.abs(pano[ok] - ref[ok]) / ref[ok]))


def overlap_pair_errors(work: str, inputs: dict, device) -> dict:
    """The relative rotation of each pair of the default exhaustive run
    (matches.npz) as panoramaEstimation's engine estimates it before the
    averaging: `robust_rotation` on `device`, pair after pair with one
    generator seeded 0 as `RotationSfM.run` draws. Returns the rotation
    errors against the truth R_j R_i^T of the pairs whose views overlap
    (optical axes less than the field of view apart), keyed "i_j"."""
    from alicevision_tpu_torch.pipeline.cli import rotation_pair_bearings
    from alicevision_tpu_torch.sfm.rotation_sfm import robust_rotation

    sc = sfmdata.load(os.path.join(work, "cameraInit.sfm"))
    focal, im_size = float(np.mean(sc.scale)), (float(sc.sizes[0, 0]), float(sc.sizes[0, 1]))
    gen = torch.Generator(device=device).manual_seed(0)
    R_true, out = inputs["R"], {}
    for (i, j), (bi, bj) in rotation_pair_bearings(sc, os.path.join(work, "features"),
                                                   os.path.join(work, "matches.npz"), device).items():
        R, _, _ = robust_rotation(gen, bi, bj, focal, im_size)
        truth = R_true[j] @ R_true[i].T
        if _angle_deg(truth) < PANO_FOV_DEG:
            out[f"{i}_{j}"] = _angle_deg(R.cpu().numpy().astype(np.float64) @ truth.T)
    return out


def panorama_report(work: str, inputs: dict, device) -> dict:
    """The chain's outputs in `work` against the truth: phi of each
    calibration method, each merged view's correlation with its true
    radiance, the rotation engines' errors (their gauge R_0 = I is the
    truth's), the exhaustive run's overlapping pairs before the averaging
    (`overlap_pair_errors` on `device`), the panoramas' median errors, and
    the side outputs."""
    w = lambda *p: os.path.join(work, *p)  # noqa: E731
    out = {}
    with np.load(w("hdr", "response_laguerre.npz")) as z:
        out["phi"] = float(z["phi"])
    for m, key in (("grossberg", "coeffs"), ("debevec", "g")):
        with np.load(w("hdr", f"response_{m}.npz")) as z:
            out[f"{m}_finite"] = bool(np.isfinite(z[key]).all())
    corr = []
    for v in range(len(inputs["R"])):
        merged = np.load(w("merged", f"view_{v:02d}.npy"))
        corr.append(float(np.corrcoef(merged.ravel(), inputs["views"][v].ravel())[0, 1]))
    out["merged_corr"] = corr
    for name in ("panorama", "panorama_seq"):
        est = sfmdata.load(w(f"{name}.sfm"))
        R_est = est.pose_R[est.view_pose]
        out[f"{name}_rotation_err_deg"] = [_angle_deg(Re @ Rt.T) for Re, Rt in zip(R_est, inputs["R"])]
    with open(w("panorama.sfm")) as a, open(w("nodal.sfm")) as b:
        out["nodal_equal"] = a.read() == b.read()
    out["overlap_pair_err_deg"] = overlap_pair_errors(work, inputs, device)
    for name in ("matches", "matches_seq"):
        with np.load(w(f"{name}.npz")) as z:
            out[f"{name}_pairs"] = len(z.files)
            out[f"{name}_total"] = int(sum(len(z[k]) for k in z.files))
    masks = [np.load(w("warped", f)) for f in sorted(os.listdir(w("warped"))) if f.endswith("_mask.npy")]
    covered = np.any(masks, axis=0)
    out["covered_frac"] = float(covered.mean())
    for name in ("pano", "pano_seams"):
        pano = np.load(w(f"{name}.npy"))
        out[f"{name}_shape"] = list(pano.shape)
        out[f"{name}_median_rel_err"] = panorama_error(pano, inputs["gt"], covered)
    # fillHoles keeps every covered pixel and divides by weights that reach
    # its 1e-6 floor far from them, where the values overflow (both
    # packages, ROADMAP §3); --crop then keeps the whole canvas
    pano = np.load(w("pano.npy"))
    post = np.load(w("pano_post.npy"))
    out["post_shape"] = list(post.shape)
    out["post_finite_frac"] = float(np.isfinite(post).mean())
    known = pano > 0
    out["post_keeps_covered"] = bool(post.shape == pano.shape and np.array_equal(post[known], pano[known]))
    # split360Images against split_equirect (on the CPU), within the 8-bit
    # quantisation of its PNGs: a truncation, so in [0, 1/255)
    from alicevision_tpu_torch.image.io import read_image
    from alicevision_tpu_torch.image.processing import split_equirect

    n = len(inputs["R"])
    ref, _, _ = split_equirect(torch.as_tensor(inputs["gt"]), n_splits=n, fov_deg=PANO_FOV_DEG, out_size=256)
    ref = np.clip(ref.numpy(), 0.0, 1.0)
    got = np.stack([read_image(w("split", f"split_{i:02d}.png")) for i in range(n)])
    out["split_quantisation"] = [float((ref - got).min()), float((ref - got).max())]
    with np.load(w("split", "cameras.npz")) as z:
        out["split_R_err"] = float(np.abs(z["R"] - inputs["R"]).max())
    out["prepared"] = len(os.listdir(w("prepared")))
    out["init_views"] = int(sfmdata.load(w("pano_init.sfm")).n_views)
    out["processed_shape"] = list(np.load(w("processed.npy")).shape)
    return out


def large_composite(work: str, inputs: dict, device) -> dict:
    """`warp_to_equirect` + `composite_panorama` of the chain's merged views
    at PANO_WIDTH_LARGE x PANO_WIDTH_LARGE / 2 on `device`, with the chain's rotations: seconds
    (to the end of the device work), peak device memory above what was
    allocated before, median relative error against the truth; then both
    blur forms of `image/filtering.py` on the (V, H, W) mask stack (one
    sigma = 2 blur of `distance_weights`), timed with CUDA events, and their
    largest difference."""
    from alicevision_tpu_torch.image.filtering import gaussian_blur_conv, gaussian_blur_mm
    from alicevision_tpu_torch.panorama import composite_panorama, warp_to_equirect

    sc = sfmdata.load(os.path.join(work, PANO_WARP_FROM))
    f32 = dict(dtype=torch.float32, device=device)
    K = torch.as_tensor(inputs["K"], **f32)
    imgs = [torch.as_tensor(np.load(os.path.join(work, "merged", f"view_{v:02d}.npy")), **f32)
            for v in range(sc.n_views)]
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    pairs = [warp_to_equirect(img, K, torch.as_tensor(sc.pose_R[sc.view_pose[v]], **f32),
                               (PANO_WIDTH_LARGE, PANO_WIDTH_LARGE // 2))
             for v, img in enumerate(imgs)]
    warps = torch.stack([p[0] for p in pairs])
    masks = torch.stack([p[1] for p in pairs])
    del pairs
    pano = composite_panorama(warps, masks)
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device) - base) / 2**30
    covered = masks.any(0).cpu().numpy()
    err = panorama_error(pano.cpu().numpy(), inputs["gt"], covered)
    m = masks.to(torch.float32)
    del warps, masks, pano
    mm_ms = _time_ms(lambda: gaussian_blur_mm(m, 2.0), reps=3, warmup=1)
    conv_ms = _time_ms(lambda: gaussian_blur_conv(m, 2.0), reps=3, warmup=1)
    diff = float((gaussian_blur_mm(m, 2.0) - gaussian_blur_conv(m, 2.0)).abs().max())
    return {"width": PANO_WIDTH_LARGE, "views": len(imgs), "seconds": seconds, "peak_gib_above_inputs": peak,
            "covered_frac": float(covered.mean()), "median_rel_err": err,
            "blur_stack_shape": list(m.shape), "blur_mm_ms": mm_ms, "blur_conv_ms": conv_ms,
            "blur_forms_max_abs_diff": diff}


def global_sfm_report(sfm_path: str, R_true: np.ndarray, c_true: np.ndarray) -> dict:
    """A globalSfM scene against the rendered poses: posed views, landmarks,
    camera-centre ATE (fraction of the ring radius) after a similarity, and
    the rotation errors after the orientations' best alignment."""
    rep = _posed_ate(sfm_path, R_true, c_true)
    sc = sfmdata.load(sfm_path)
    posed = sc.valid_views()
    errs, _ = rotation_errors_deg(sc.pose_R[sc.view_pose[posed]], R_true[posed])
    return {"n_posed": rep["n_posed"], "landmarks": rep["landmarks"], "ate_frac_of_radius": rep["ate_frac_of_radius"],
            "rotation_err_deg": errs}


def run_panorama_phase(dev, work: str, cli_out: str, posed_sfm: str, smi: str) -> dict:
    """The panorama phase's runs: the chain of `panorama_chain` in this
    process through `cli.main` on the card, its report against the truth,
    the warp and composite at PANO_WIDTH_LARGE, and relativePoseEstimating
    -> globalSfM on the cli phase's features and matches (`cli_out`), with
    the SGM launches of all of it. Returns the `panorama` row."""
    from alicevision_tpu_torch.pipeline import cli

    t_phase = time.perf_counter()
    out = os.path.join(work, "panorama")
    extra = ["--device", str(dev)]
    sgm_kernel.launches.update(dict.fromkeys(sgm_kernel.launches, 0))
    t0 = time.perf_counter()
    inputs = make_panorama_inputs(out, dev)
    inputs_s = time.perf_counter() - t0
    stages_ = run_panorama_chain(cli.main, out, inputs, extra=extra, device=dev)
    rep = panorama_report(out, inputs, dev)
    large = large_composite(out, inputs, dev)

    truth = sfmdata.load(posed_sfm)
    R_true, c_true = truth.pose_R[truth.view_pose], truth.pose_c[truth.view_pose]
    rel, glob = os.path.join(out, "relative_poses.npz"), os.path.join(out, "global.sfm")
    args = ["--input", os.path.join(cli_out, "cameraInit.sfm"), "--features", os.path.join(cli_out, "features"),
            "--matches", os.path.join(cli_out, "matches.npz")]
    gsec = {}
    for name, argv in (("relativePoseEstimating", [*args, "--output", rel]),
                       ("globalSfM", [*args, "--relativePoses", rel, "--output", glob])):
        t0 = time.perf_counter()
        if cli.main([name, *argv, *extra]) != 0:
            raise RuntimeError(f"panorama: {name} on the cli phase's features failed")
        torch.cuda.synchronize(dev)
        gsec[name] = time.perf_counter() - t0
    gl = global_sfm_report(glob, R_true, c_true)
    gl["seconds"] = gsec
    launches = dict(sgm_kernel.launches)

    row = {
        "device": smi,
        "inputs": {"gt_wh": list(PANO_GT_WH), "views": PANO_N_VIEWS, "view_px": PANO_VIEW_PX, "fov_deg": PANO_FOV_DEG,
                   "exposures": list(PANO_EXPOSURES), "phi": PANO_PHI, "seconds": inputs_s},
        "stage_seconds": {k: v["seconds"] for k, v in stages_.items()},
        "stage_device_peak_gib": {k: v["device_peak_gib"] for k, v in stages_.items()},
        "chain_seconds": sum(v["seconds"] for v in stages_.values()),
        "report": rep,
        "large": large,
        "global": gl,
        "sgm_launches": launches,
        "phase_seconds": time.perf_counter() - t_phase,
    }
    print("panorama " + json.dumps(row), flush=True)
    return row


def check_panorama(dev, work: str, cli_out: str, posed_sfm: str, smi: str) -> tuple:
    """The panorama phase (`run_panorama_phase`) and its gates. Returns (the
    `panorama` row, its SGM launches, all 0)."""
    row = run_panorama_phase(dev, work, cli_out, posed_sfm, smi)
    rep, large, gl, launches = row["report"], row["large"], row["global"], row["sgm_launches"]
    bad = []
    if not abs(rep["phi"] - PANO_PHI) < PANO_PHI_ERR:
        bad.append(f"Laguerre phi {rep['phi']}, expected within {PANO_PHI_ERR} of {PANO_PHI}")
    if not (rep["grossberg_finite"] and rep["debevec_finite"]):
        bad.append("a Grossberg or Debevec response is not finite")
    if not min(rep["merged_corr"]) >= PANO_MIN_CORR:
        bad.append(f"merged radiance correlations {rep['merged_corr']}, expected >= {PANO_MIN_CORR}")
    if not max(rep["panorama_seq_rotation_err_deg"]) < PANO_ROT_DEG:
        bad.append(f"panorama_seq: rotation errors {rep['panorama_seq_rotation_err_deg']} deg, expected "
                   f"< {PANO_ROT_DEG}")
    pairs = rep["overlap_pair_err_deg"]
    if not (len(pairs) == PANO_OVERLAP_PAIRS and max(pairs.values()) < PANO_PAIR_DEG):
        bad.append(f"panorama: overlapping pairs' rotation errors {pairs} deg, expected {PANO_OVERLAP_PAIRS} "
                   f"pairs < {PANO_PAIR_DEG}")
    if not rep["nodal_equal"]:
        bad.append("nodalSfM's scene differs from panoramaEstimation's")
    for key, width in (("pano", PANO_WIDTH), ("pano_seams", PANO_WIDTH)):
        if not (rep[f"{key}_shape"] == [width // 2, width] and rep[f"{key}_median_rel_err"] < PANO_MED_ERR[width]):
            bad.append(f"{key}: {rep[f'{key}_shape']}, median error {rep[f'{key}_median_rel_err']}, expected "
                       f"< {PANO_MED_ERR[width]}")
    if not large["median_rel_err"] < PANO_MED_ERR[PANO_WIDTH_LARGE]:
        bad.append(f"the {PANO_WIDTH_LARGE} composite's median error {large['median_rel_err']}, expected "
                   f"< {PANO_MED_ERR[PANO_WIDTH_LARGE]}")
    # the fill overflows away from the covered pixels in both packages (the
    # reference's output is finite exactly where the panorama is covered)
    if not (rep["post_keeps_covered"] and rep["post_finite_frac"] >= rep["covered_frac"] - 1e-6):
        bad.append(f"panoramaPostProcessing: {rep['post_shape']}, covered pixels kept {rep['post_keeps_covered']}, "
                   f"finite {rep['post_finite_frac']}, expected >= the covered {rep['covered_frac']}")
    # 8-bit truncation, in [0, 1/255), widened by the float rounding between
    # the card's sampling and the CPU's (the JAX chain: -1.5e-5)
    if not (-1e-4 <= rep["split_quantisation"][0] and rep["split_quantisation"][1] < 1.0 / 255 + 1e-4
            and rep["split_R_err"] < 1e-6):
        bad.append(f"split360Images: {rep['split_quantisation']}, R {rep['split_R_err']}")
    if not (rep["prepared"] == len(PANO_EXPOSURES) and rep["init_views"] == PANO_N_VIEWS
            and rep["processed_shape"] == [PANO_VIEW_PX // 2] * 2):
        bad.append(f"side commands: {rep['prepared']} prepared, {rep['init_views']} views, "
                   f"{rep['processed_shape']} processed")
    if not (gl["n_posed"] == 8 and max(gl["rotation_err_deg"]) < GLOBAL_ROT_DEG
            and gl["ate_frac_of_radius"] < GLOBAL_ATE_FRAC):
        bad.append(f"globalSfM: {gl['n_posed']} posed, rotations {gl['rotation_err_deg']} deg, ATE "
                   f"{gl['ate_frac_of_radius']}, expected 8, < {GLOBAL_ROT_DEG}, < {GLOBAL_ATE_FRAC}")
    if any(launches.values()):
        bad.append(f"the panorama path launched SGM kernels: {launches}")
    if bad:
        raise RuntimeError("panorama: " + "; ".join(bad))
    return row, launches


# ------------------------------------------------------------------ localization

# The localization phase (after hard_scene, on the images path's
# reconstruction `hard_sfm.sfm` and its DSP-SIFT features): 8 query views
# rendered midway between ring neighbours of the same distorted box world,
# cameraLocalization (voctree and direct: at the CLI's defaults, at full
# resolution, and at the defaults on the queries' 1024x768 windows), a
# two-camera rig (camera 1 at a fixed sub-pose) through rigCalibration ->
# rigTransform / sfmToRig -> rigLocalization (joint fusion on the full
# queries, average fusion on the windows),
# the remaining resection solvers on the card against the CPU, frustum
# pairs, the scene tools' round trip and a tag16h5 marker sequence through
# featureExtraction, localize_by_markers and refine_sequence. Every command
# runs in this process through `cli.main`. Its gates are the JAX chain's
# readings on the same inputs (scripts/localization_reference.py, on the
# CPU) with a margin; it launches no SGM kernel.
LOC_QUERIES = 8
LOC_SUB_YAW_DEG, LOC_SUB_SIDE = 15.0, 0.25  # camera 1: yaw about camera 0's y axis, offset along its x axis
LOC_RIG_NOISE = 1e-3  # rad and units: the posed rig scenes' noise around the truth
LOC_SOLVER_BATCH, LOC_SOLVER_CPU = 4096, 512  # samples a solver call, and the CPU's share of them
LOC_SOLVER_F = (450.0, 1800.0)  # the focal sweeps' range around the hard scene's 900 px
LOC_SOLVER_K1 = -0.15  # P5Pfr's division-model distortion of its samples
# queries of at most the CLI's --downscaleTo 1024 are not decimated: the
# top-left 1024x768 of each render keeps the database camera's pixel frame
LOC_CROP = (1024, 768)
# camera 0's queries rendered again at LOC_2X times the resolution (2560x1920,
# the same field of view): the default decimation (step 3) leaves a query at
# 2/3 of the database's scale where the 1280-px render is halved, and the CLI
# reads them against the reconstruction with its intrinsics scaled to that
# frame (`scaled_database`: the same camera at LOC_2X times the pixels), as
# it maps every query's pixels through the database's intrinsics
LOC_2X = 2
LOC_FRUSTUM_Z = (1.0, 4.5)  # frusta reaching 1.5 units short of the ring's centre: opposite views miss
LOC_MARKER = dict(frames=6, wh=(640, 480), focal_px=600.0, focal0=1.05, tags=9)
# The JAX chain on a card reconstruction saved by
# scripts/localization_phase_torch.py (scripts/localization_reference.py,
# on the CPU), queries right of 8 with the CLI's draw: at the defaults 1
# (voctree) and 0 (direct), since a halved query's SIFT is at half the scale
# of the database's full-resolution DSP-SIFT; at full resolution 3 and 7;
# on the 1024x768 windows at the defaults 2 and 7. Rig frames: 8 (joint)
# and 8 (average, on the windows). Errors up to 0.37 deg and 0.49 % of
# the radius a query, 0.45 deg and 1.24 % a rig frame (the calibrated
# sub-pose meets the reconstruction's own 2.8 deg tilt); none wrong. The
# sub-pose is off by 0.055 deg and 3.5e-4. P4Pf and P5Pfr recover the
# focal on 99.54 % and 99.85 % of the samples. Each single-draw count
# gate takes one query of margin: every chip run localizes against a new
# reconstruction. The natural 8 of 8 is missed by the reference and not
# gated. No wrong
# success is allowed. The reference's wrong successes come from the fault
# that `localizer.resect_padded` repairs (ROADMAP §3); the port's voctree
# runs met 42 of them in 32 draws on the card before the repair and none
# after.
#
# The runs whose counts depend on the draw are repeated in the phase's
# process for LOC_SWEEP_SEEDS seeds of the tree and RANSAC
# (`localization_sweep`, draw 0 the CLI's), and their counts gated on the
# K-draw totals. Each gate is the LOC_K_ALPHA quantile of the K-draw total
# of a tree that localizes as the JAX package does, whatever reconstruction
# the card gives the run (scripts/localization_gates_reference.py, from
# JAX's draws in scripts/localization_k_draw_readings.json: its CLI's loop,
# scripts/localization_reference.py --sweep-only on the CPU, 168 draws on
# 10 card reconstructions): full resolution 57 of 256, windows 38, 2x 9,
# direct at 2x 64 (K times the fewest JAX read in one draw, 2: its spread is
# between reconstructions, 2.91-4.88 a draw, skewed upwards), voctree at
# the halved defaults 1. A tree that loses a quarter of its right queries
# falls under the first two in 44 % and 19 % of its runs, a half in 99.8 %
# and 87 % (the script's thinned draws). 8-draw totals spread 10-27 (full)
# and 9-24 (windows) over 32 draws on one reconstruction (the port on the
# CPU; JAX 15-25 and 10-22 on another), so the earlier gates at JAX's
# lowest 8-draw total of 18 blocks read (14, 9, 3, 23) failed a sound tree
# in about one run in ten (3.4, 3.1, 1.5 and 1.7 % of the script's draws);
# these fail one in 200 (0.17, 0.19, 0.01, 0 and, at the defaults, 0.13 %).
# Direct at full resolution and on the windows read 6-7 in every draw in
# both packages (4 card reconstructions x 8 draws): they keep their
# single-draw gates.
LOC_SWEEP_SEEDS = 32
LOC_K_ALPHA = 1e-3
LOC_SWEEP_RUNS = ("voctree", "voctree_full", "voctree_crop", "voctree_2x", "direct_2x")
LOC_GATES = dict(
    # right, of LOC_QUERIES, in the CLI's draw
    localized={"voctree": 0, "direct": 0, "direct_full": 6, "direct_crop": 6},
    # right over the LOC_SWEEP_SEEDS draws of `localization_sweep`, of
    # LOC_QUERIES a draw
    localized_k={"voctree": 1, "voctree_full": 57, "voctree_crop": 38, "voctree_2x": 9, "direct_2x": 64},
    rot_deg=0.5, centre_frac=0.01,  # a query localized right: centre error over the ring's radius
    wrong=0,  # successes that miss the place (wrong_rot_deg or wrong_centre_frac off), of a run
    wrong_rot_deg=5.0, wrong_centre_frac=0.05,
    # a rig frame right within these at a reconstruction's camera tilt up to
    # rig_tilt_deg, and within them scaled by tilt / rig_tilt_deg above it
    # (`rig_tolerances`): on a 4.34 deg card reconstruction the JAX chain
    # has 6 (joint) and 5 (average) of 8 within 1 deg and 2 %, 7 and 7
    # within the scaled 1.55 deg and 3.1 %; the card's reconstructions tilt
    # 0.54-4.34 deg from run to run
    rig_frames={"joint": 7, "average": 7}, rig_rot_deg=1.0, rig_centre_frac=0.02, rig_tilt_deg=2.8,
    subpose_rot_deg=0.2, subpose_centre=0.01,
    solver_recovered=0.98, solver_agree=0.98, linear_rot_deg=0.01,
    marker_focal=0.01, marker_rms_px=0.5,
)


# the phase's cameraLocalization runs, in its chain's order
LOC_CAMERA_RUNS = ("voctree", "direct", "voctree_full", "direct_full", "voctree_crop", "direct_crop", "voctree_2x",
                   "direct_2x")


def localization_camera_runs(inputs: dict) -> dict:
    """LOC_CAMERA_RUNS -> (--method, query folder, --downscaleTo or None
    for the CLI's default 1024, True where the run reads the database
    scaled to the LOC_2X frame): camera 0's renders at the defaults and at
    full resolution (the defaults halve a 1280-px query: SIFT of half the
    scale against the database's full-resolution DSP-SIFT, as
    rigLocalization's joint path does not), their windows at the defaults,
    and the LOC_2X renders at the defaults."""
    q0, c0, q2 = inputs["folders"][0], inputs["crops"][0], inputs["folder_2x"]
    runs = {}
    for method in ("voctree", "direct"):
        runs[method] = (method, q0, None, False)
        runs[f"{method}_full"] = (method, q0, 0, False)
        runs[f"{method}_crop"] = (method, c0, None, False)
        runs[f"{method}_2x"] = (method, q2, None, True)
    return {name: runs[name] for name in LOC_CAMERA_RUNS}


def scale_intrinsics(sc, k: int = LOC_2X):
    """Scene `sc` with every intrinsic scaled to k times the pixels, in
    place: the same camera in a k-times finer pixel frame (focal and size
    times k, the principal point moved with the pixel centres: pp_k + 0.5 =
    k (pp + 0.5)); the poses, landmarks and observations unchanged."""
    sc.scale = sc.scale * k
    sc.sizes = (sc.sizes * k).astype(np.int32)
    sc.offset = sc.offset * k + 0.5 * (k - 1)
    return sc


def scaled_database(sfm: str, out: str, k: int = LOC_2X) -> None:
    """`scale_intrinsics` of the scene file `sfm`, written to `out`."""
    sfmdata.save(scale_intrinsics(sfmdata.load(sfm), k), out)


def _look_at_rows(c: np.ndarray) -> np.ndarray:
    """World->camera rotations (rows right, down, forward) of cameras at
    centres c (N, 3) looking at the origin, z up (the hard ring's)."""
    fwd = -c / np.linalg.norm(c, axis=-1, keepdims=True)
    right = np.cross(fwd, np.broadcast_to([0.0, 0.0, 1.0], fwd.shape))
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    return np.stack([right, np.cross(fwd, right), fwd], axis=-2)


def localization_poses(n_queries: int = LOC_QUERIES, n_views: int = HARD_VIEWS, radius: float = 6.0) -> dict:
    """Query poses midway (in angle) between ring neighbours i, i+1 with i
    spread over the ring, on its height curve, looking at the origin:
    camera 0's (R0, c0) and the rig's camera 1 (R1 = R_s R0, c1 = c0 +
    R0ᵀ c_rel) with the sub-pose (R_s, c_rel) of LOC_SUB_*."""
    from alicevision_tpu_torch.utils.rendered import _ring_cameras

    _, _, c_ring = _ring_cameras(n_views, radius, 1.2, HARD_IMG["focal_px"], HARD_IMG["wh"], 0)
    ang = np.unwrap(np.arctan2(c_ring[:, 1], c_ring[:, 0]))
    ang = np.append(ang, ang[0] + 2 * np.pi)
    i = (np.arange(n_queries) * n_views) // n_queries
    a = 0.5 * (ang[i] + ang[i + 1])
    c0 = np.stack([radius * np.cos(a), radius * np.sin(a), 1.2 * np.sin(2.1 * a)], axis=-1)
    R0 = _look_at_rows(c0)
    y = math.radians(LOC_SUB_YAW_DEG)
    R_s = np.array([[math.cos(y), 0.0, -math.sin(y)], [0.0, 1.0, 0.0], [math.sin(y), 0.0, math.cos(y)]])
    c_rel = np.array([LOC_SUB_SIDE, 0.0, 0.0])
    return dict(R0=R0, c0=c0, R1=R_s @ R0, c1=c0 + np.einsum("qji,j->qi", R0, c_rel), sub_R=R_s, sub_c=c_rel)


def render_at_poses(R: np.ndarray, c: np.ndarray, wh=HARD_IMG["wh"], focal_px: float = HARD_IMG["focal_px"],
                    disto=(-0.25, 0.06, -0.005), device="cuda") -> np.ndarray:
    """`render_hard_views`'s ray caster at given poses: the distorted box
    world seen by cameras (R (N, 3, 3) world->cam, c (N, 3)), float64 on
    `device`. Returns (N, H, W) float32 images."""
    from alicevision_tpu_torch.utils.rendered import (
        _noise_grid, _ray_box_t_torch, _texture_rich_torch, _undistort_radial_k3_torch, default_boxes)

    w, h = wh
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                            torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    xd = torch.stack([(xs + 0.5 - w / 2.0) / focal_px, (ys + 0.5 - h / 2.0) / focal_px], dim=-1)
    xn = _undistort_radial_k3_torch(xd, np.asarray(disto, np.float64)).reshape(-1, 2)
    dirs_cam = torch.cat([xn, torch.ones_like(xn[:, :1])], dim=-1)
    boxes = torch.as_tensor(default_boxes(), dtype=torch.float64, device=device)
    grid = torch.as_tensor(_noise_grid(11), device=device)
    out = []
    for Rv, cv in zip(torch.as_tensor(R, dtype=torch.float64, device=device),
                      torch.as_tensor(c, dtype=torch.float64, device=device)):
        img = []
        for dc in dirs_cam.split(1 << 20):  # a pixel at a time, in chunks: a 2560x1920 view on a host
            dirs = dc @ Rv
            o = cv.expand_as(dirs)
            t = _ray_box_t_torch(o, dirs, boxes).amin(dim=-1)
            hit = torch.isfinite(t)
            tex = _texture_rich_torch(o + torch.where(hit, t, torch.zeros_like(t))[:, None] * dirs, grid)
            img.append(torch.where(hit, tex, torch.full_like(tex, 0.5)).to(torch.float32))
        out.append(torch.cat(img).reshape(h, w))
    return torch.stack(out).cpu().numpy()


def _posed_scene(path: str, R: np.ndarray, c: np.ndarray, wh, focal_px: float, id_base: int):
    """A posed .sfm of N views (frame k = view k), one pinhole intrinsic."""
    sc = sfmdata.SfMData.empty()
    ii = sc.add_intrinsic(1, wh[0], wh[1], focal_px)
    for k in range(len(R)):
        v = sc.add_view(id_base + k, ii, wh[0], wh[1], path=f"q_{k:02d}.npy", frame_id=k)
        sc.set_pose(v, R[k], c[k])
    sfmdata.save(sc, path)


def make_localization_inputs(work: str, device, n_queries: int = LOC_QUERIES, wh=HARD_IMG["wh"],
                             focal_px: float = HARD_IMG["focal_px"], disto=(-0.25, 0.06, -0.005)) -> dict:
    """The phase's queries and rig scenes in `work`: both rig cameras'
    renders (loc_q0/, loc_q1/, q_<k>.npy), their top-left LOC_CROP
    windows (loc_c0/, loc_c1/) and camera 0's at LOC_2X times the
    resolution (loc_q0_2x/), and each camera's posed .sfm from the truth
    with LOC_RIG_NOISE (seeded), frames = queries."""
    poses = localization_poses(n_queries)
    rng = np.random.RandomState(5)
    inputs = dict(poses=poses, wh=tuple(wh), focal_px=focal_px, folders=[], crops=[], rig_sfm=[],
                  folder_2x=os.path.join(work, "loc_q0_2x"))
    t0 = time.perf_counter()
    os.makedirs(inputs["folder_2x"], exist_ok=True)
    wh2 = (LOC_2X * wh[0], LOC_2X * wh[1])
    for q, img in enumerate(render_at_poses(poses["R0"], poses["c0"], wh2, LOC_2X * focal_px, disto, device)):
        np.save(os.path.join(inputs["folder_2x"], f"q_{q:02d}.npy"), img)
    for k in (0, 1):
        R, c = poses[f"R{k}"], poses[f"c{k}"]
        folder, crops = os.path.join(work, f"loc_q{k}"), os.path.join(work, f"loc_c{k}")
        os.makedirs(folder, exist_ok=True)
        os.makedirs(crops, exist_ok=True)
        for q, img in enumerate(render_at_poses(R, c, wh, focal_px, disto, device)):
            np.save(os.path.join(folder, f"q_{q:02d}.npy"), img)
            np.save(os.path.join(crops, f"q_{q:02d}.npy"), np.ascontiguousarray(img[:LOC_CROP[1], :LOC_CROP[0]]))
        inputs["crops"].append(crops)
        dR = so3_exp(torch.as_tensor(rng.normal(0, LOC_RIG_NOISE, (len(R), 3)))).numpy()
        noisy_R = dR @ R
        noisy_c = c + rng.normal(0, LOC_RIG_NOISE, c.shape)
        path = os.path.join(work, f"loc_cam{k}.sfm")
        _posed_scene(path, noisy_R, noisy_c, wh, focal_px, 100 * (k + 1))
        inputs["folders"].append(folder)
        inputs["rig_sfm"].append(path)
    inputs["render_s"] = time.perf_counter() - t0
    return inputs


def localization_chain(work: str, inputs: dict, sfm: str, feats: str, truth_sfm: str) -> list:
    """(subcommand, argv) of the phase, in order."""
    def w(*p):
        return os.path.join(work, *p)

    q0, q1 = inputs["folders"]
    c0, c1 = inputs["crops"]
    zn, zf = LOC_FRUSTUM_Z
    loc = ["--input", sfm, "--features", feats]
    sfm_2x = w("database_2x.sfm")
    scaled_database(sfm, sfm_2x)
    camera = [("cameraLocalization", ["--input", sfm_2x if scaled else sfm, "--features", feats, "--queryFolder",
                                      folder, "--output", w(f"loc_{name}.json"), "--method", method,
                                      *([] if ds is None else ["--downscaleTo", str(ds)])])
              for name, (method, folder, ds, scaled) in localization_camera_runs(inputs).items()]
    return [
        *camera,
        ("rigCalibration", ["--inputs", ",".join(inputs["rig_sfm"]), "--output", w("rig.json")]),
        ("rigTransform", ["--input", inputs["rig_sfm"][0], "--rig", w("rig.json"), "--camera", "1",
                          "--output", w("cam1_from_rig.sfm")]),
        ("sfmToRig", ["--input", inputs["rig_sfm"][0], "--output", w("sfm_rig.json")]),
        ("rigLocalization", [*loc, "--queryFolders", f"{q0},{q1}", "--rig", w("rig.json"),
                             "--output", w("rig_joint.json"), "--fusion", "joint"]),
        # average fusion localizes each camera at the defaults: the windows
        ("rigLocalization", [*loc, "--queryFolders", f"{c0},{c1}", "--rig", w("rig.json"),
                             "--output", w("rig_average.json"), "--fusion", "average"]),
        ("frustumFiltering", ["--input", truth_sfm, "--output", w("frustum_pairs.txt"), "--zNear", str(zn),
                              "--zFar", str(zf)]),
        ("sfmSplitReconstructed", ["--input", sfm, "--output", w("rec.sfm"),
                                   "--outputNonReconstructed", w("non.sfm")]),
        ("sfmMerge", ["--input", w("rec.sfm"), "--input2", w("non.sfm"), "--output", w("merged.sfm")]),
        ("sfmRegression", ["--input", sfm, "--reference", sfm]),
        ("sfmTransfer", ["--input", truth_sfm, "--reference", sfm, "--output", w("transferred.sfm")]),
        ("applyCalibration", ["--input", truth_sfm, "--calibration", sfm, "--output", w("calibrated.sfm")]),
        ("sfmDistances", ["--input", sfm]),
        ("generateSampleScene", ["--output", w("sample.sfm")]),
    ]


LOC_STEP_LOG = "[av] cameraLocalization seconds by step: "


def run_localization_chain(main, chain: list, extra=(), device=None) -> dict:
    """`run_chain` of `chain` with each command's printed JSON kept ("out":
    the last one-line object, or one printed with indents) and the seconds
    by step that the port's cameraLocalization logs to stderr
    ("step_seconds", None from a CLI that logs none)."""
    import contextlib
    import io

    printed = {}

    def quiet(argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
        printed["text"], printed["err"] = out.getvalue().strip(), err.getvalue()
        if rc:
            sys.stderr.write(printed["err"])
        return rc

    def after(name, row):
        text = printed["text"]
        last = text.splitlines()[-1] if text else ""
        row["out"] = json.loads(last) if last.startswith("{") else json.loads(text[text.find("{"):]) if text else None
        steps = [ln[len(LOC_STEP_LOG):] for ln in printed["err"].splitlines() if ln.startswith(LOC_STEP_LOG)]
        row["step_seconds"] = json.loads(steps[-1]) if steps else None

    return run_chain(quiet, chain, "localization", extra, device, after)


def with_feature_ids(sfm: str, feats: str, out: str) -> int:
    """Write `sfm` to `out` with each observation's feature id. The SfM
    engines of both packages export observations numbered 0..O-1, not by
    feature (ROADMAP §3), and the localizers look descriptors up by feature
    id; an observation's pixel is its feature's, bit for bit, so the id is
    recovered by position (the first of features at one position, which
    differ in orientation only). Returns the observations left unmatched."""
    sc = sfmdata.load(sfm)
    fid = np.full(sc.n_observations, -1, np.int64)
    for v in np.unique(sc.obs_view):
        xy = stages.load_features(feats, int(sc.view_ids[v]))["xy"].astype(np.float64)
        first = {}
        for i, p in enumerate(map(tuple, xy)):
            first.setdefault(p, i)
        sel = np.nonzero(sc.obs_view == v)[0]
        fid[sel] = [first.get(tuple(p), -1) for p in sc.obs_uv[sel]]
    missing = int((fid < 0).sum())
    sc.obs_feature = np.maximum(fid, 0)
    sfmdata.save(sc, out)
    return missing


def _truth_scene(sfm: str, out: str, R_gt: np.ndarray, c_gt: np.ndarray) -> None:
    """The reconstruction's scene with every view posed at the truth (view
    v is image v of the ring); only the poses are used."""
    sc = sfmdata.load(sfm)
    for v in range(sc.n_views):
        sc.set_pose(v, R_gt[v], c_gt[v])
    sfmdata.save(sc, out)


def _database_frame(sc, R_gt, c_gt) -> tuple:
    """The reconstruction's frame against the truth's: the similarity (s,
    Ra, t) of its centres, and the camera-side rotation C that its views
    share, the chordal mean of R_v Raᵀ R_trueᵀ (a principal point the
    engine misplaces comes out as a common tilt of every camera)."""
    posed = sc.valid_views()
    est_c = np.stack([sc.pose_c[sc.view_pose[v]] for v in posed])
    s, Ra, t = _align_similarity(est_c, c_gt[posed])
    M = sum(sc.pose_R[sc.view_pose[v]] @ Ra.T @ R_gt[v].T for v in posed)
    U, _, Vt = np.linalg.svd(M)
    C = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    return (s, Ra, t), C


def _pose_errors(results: dict, names, R_true, c_true, align, C, radius: float) -> dict:
    """Rotation (deg) and centre (fraction of the radius) errors of JSON
    poses in the reconstruction's frame, mapped by the similarity `align`
    (s, Ra, t) into the truth's, the rotations less the reconstruction's
    common camera tilt C."""
    s, Ra, t = align
    rot, cen, ok = [], [], 0
    for q, name in enumerate(names):
        r = results.get(name, {})
        if not r.get("success"):
            rot.append(None)
            cen.append(None)
            continue
        ok += 1
        rot.append(_angle_deg(C.T @ np.asarray(r["R"]) @ Ra.T @ R_true[q].T))
        cen.append(float(np.linalg.norm(s * Ra @ np.asarray(r["c"]) + t - c_true[q]) / radius))
    return {"localized": ok, "rot_err_deg": rot, "centre_err_frac": cen}


def localization_report(work: str, rows: dict, inputs: dict, sfm: str, truth_sfm: str, R_gt, c_gt, device) -> dict:
    """The chain's outputs against the truth."""
    from alicevision_tpu_torch.sfm.frustum import frustum_pairs

    poses = inputs["poses"]
    sc = sfmdata.load(sfm)
    align, C = _database_frame(sc, R_gt, c_gt)
    radius = float(np.linalg.norm(c_gt - c_gt.mean(0), axis=1).mean())
    names = [f"q_{q:02d}.npy" for q in range(len(poses["R0"]))]
    rep = {"align_scale": float(align[0]), "database_tilt_deg": _angle_deg(C),
           "database_pp_offset_px": sc.offset[0].tolist()}

    def load(name):
        with open(os.path.join(work, name)) as f:
            return json.load(f)

    for key in LOC_CAMERA_RUNS:
        rep[f"camera_{key}"] = _pose_errors(load(f"loc_{key}.json"), names, poses["R0"], poses["c0"], align, C,
                                            radius)
    for fusion in ("joint", "average"):
        rep[f"rig_{fusion}"] = _pose_errors(load(f"rig_{fusion}.json"), names, poses["R0"], poses["c0"], align, C,
                                            radius)
    sub = load("rig.json")["subposes"][1]
    rep["subpose_rot_err_deg"] = _angle_deg(np.asarray(sub["R"]) @ poses["sub_R"].T)
    rep["subpose_centre_err"] = float(np.linalg.norm(np.asarray(sub["c"]) - poses["sub_c"]))
    moved = sfmdata.load(os.path.join(work, "cam1_from_rig.sfm"))
    rep["rig_transform_max_centre_err"] = float(max(
        np.linalg.norm(moved.pose_c[moved.view_pose[v]] - poses["c1"][v]) for v in range(moved.n_views)))
    rep["sfm_to_rig_cameras"] = rows["sfmToRig"]["out"]["cameras"]

    with open(os.path.join(work, "frustum_pairs.txt")) as f:
        cli_pairs = np.array([[int(x) for x in line.split()] for line in f if line.strip()], np.int64)
    truth = sfmdata.load(truth_sfm)
    cpu_pairs = frustum_pairs(truth, *LOC_FRUSTUM_Z, device="cpu")
    card_pairs = frustum_pairs(truth, *LOC_FRUSTUM_Z, device=device)
    n_posed = len(truth.valid_views())
    rep["frustum"] = {"pairs": int(len(cli_pairs)), "of": n_posed * (n_posed - 1) // 2,
                      "cli_equals_cpu": bool(np.array_equal(cli_pairs.reshape(-1, 2), cpu_pairs)),
                      "card_equals_cpu": bool(np.array_equal(card_pairs, cpu_pairs))}

    merged = sfmdata.load(os.path.join(work, "merged.sfm"))
    by_id = {int(merged.view_ids[v]): v for v in range(merged.n_views)}
    same_poses = all(
        (sc.view_pose[v] < 0) == (merged.view_pose[by_id[int(i)]] < 0)
        and (sc.view_pose[v] < 0 or (np.array_equal(sc.pose_R[sc.view_pose[v]],
                                                    merged.pose_R[merged.view_pose[by_id[int(i)]]])
                                     and np.array_equal(sc.pose_c[sc.view_pose[v]],
                                                        merged.pose_c[merged.view_pose[by_id[int(i)]]])))
        for v, i in enumerate(sc.view_ids))
    rep["split_merge"] = {"views": [int(sc.n_views), int(merged.n_views)],
                          "landmarks": [int(sc.n_landmarks), int(merged.n_landmarks)],
                          "observations": [int(sc.n_observations), int(merged.n_observations)],
                          "same_ids": set(by_id) == {int(i) for i in sc.view_ids}, "same_poses": bool(same_poses)}
    reg = rows["sfmRegression"]["out"]
    rep["regression_self"] = {k: reg[k] for k in ("common_poses", "rotation_deg_max", "center_dist_max")}
    rep["transfer"] = rows["sfmTransfer"]["out"]
    rep["apply_calibration"] = rows["applyCalibration"]["out"]
    rep["distances"] = rows["sfmDistances"]["out"]
    rep["sample_scene"] = rows["generateSampleScene"]["out"]
    return rep


def solver_samples(n: int, seed: int = 0) -> dict:
    """n 6-point samples of the hard scene's truth: a random view and 6 of
    the points it sees. Returns world (n, 6, 3), normalized undistorted
    observations (n, 6, 2), centred pixels (n, 6, 2), the same divided by
    the division model at LOC_SOLVER_K1 (n, 6, 2), and the views' (R, t)."""
    from alicevision_tpu_torch.utils.rendered import hard_scene

    hs = hard_scene(HARD_VIEWS, HARD_POINTS)
    rng = np.random.RandomState(seed)
    f = float(hs.K[0, 0])
    world, xn, Rs, ts = [], [], [], []
    while len(world) < n:
        v = rng.randint(HARD_VIEWS)
        vis = np.nonzero(hs.visible[v])[0]
        pick = rng.choice(vis, 6, replace=False)
        X = hs.points[pick]
        xc = (X - hs.c[v]) @ hs.R[v].T
        world.append(X)
        xn.append(xc[:, :2] / xc[:, 2:])
        Rs.append(hs.R[v])
        ts.append(-hs.R[v] @ hs.c[v])
    world, xn = np.stack(world), np.stack(xn)
    # x_d with x_u = x_d / (1 + k |x_d|^2), radially
    r_u = np.linalg.norm(xn, axis=-1, keepdims=True)
    k = LOC_SOLVER_K1
    r_d = (1.0 - np.sqrt(1.0 - 4.0 * k * r_u**2)) / (2.0 * k * np.maximum(r_u, 1e-12))
    return dict(world=world.astype(np.float32), xn=xn.astype(np.float32), px=(xn * f).astype(np.float32),
                px_k1=(xn * (r_d / np.maximum(r_u, 1e-12)) * f).astype(np.float32), focal=f,
                R=np.stack(Rs), t=np.stack(ts))


def _solver_calls(smp: dict, device, n: int) -> dict:
    """name -> a call of the solver on the first n samples on `device`."""
    from alicevision_tpu_torch import multiview as mv

    def t(a):
        return torch.as_tensor(a[:n], device=device)

    lo, hi = LOC_SOLVER_F
    return {
        "resection_dlt6": lambda: mv.resection_dlt6(t(smp["world"]), t(smp["xn"])),
        "epnp": lambda: mv.epnp(t(smp["world"]), t(smp["xn"])),
        "p4pf": lambda: mv.p4pf(t(smp["world"][:, :4]), t(smp["px"][:, :4]), lo, hi),
        "p5pfr": lambda: mv.p5pfr(t(smp["world"][:, :5]), t(smp["px_k1"][:, :5]), lo, hi),
    }


def _recovered_focal(out, focal: float, k1=None) -> np.ndarray:
    """Per sample, the focal of the valid candidate nearest the truth among
    those within 1 % of it (and within 0.01 of k1), else NaN."""
    f, ok = out[2].cpu().numpy(), out[-1].cpu().numpy()
    near = ok & (np.abs(f - focal) < 0.01 * focal)
    if k1 is not None:
        near &= np.abs(out[3].cpu().numpy() - k1) < 0.01
    d = np.where(near, np.abs(f - focal), np.inf)
    best = np.argmin(d, axis=-1)
    return np.where(near.any(-1), np.take_along_axis(f, best[:, None], -1)[:, 0], np.nan)


def check_solvers(device, n: int = LOC_SOLVER_BATCH, n_cpu: int = LOC_SOLVER_CPU) -> dict:
    """The four solvers on n samples on `device` (timed, best of 3) and on
    the first n_cpu on the CPU: the linear ones' rotation error to the truth
    and the card's largest distance to the CPU's R where the CPU's solve is
    right; the focal solvers' share of samples with the focal recovered,
    and the share of the CPU's samples where the card recovers the same
    focal (rtol 1e-3)."""
    smp = solver_samples(n)
    card, cpu = _solver_calls(smp, device, n), _solver_calls(smp, "cpu", n_cpu)
    rows = {}
    for name, call in card.items():
        times = []
        for _ in range(3):
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = call()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        ref = cpu[name]()
        row = {"samples": n, "ms": min(times), "cpu_samples": n_cpu,
               "cpu_ms": (time.perf_counter() - t0) * 1e3}
        if name in ("resection_dlt6", "epnp"):
            R, R_cpu = out[0].cpu().numpy(), ref[0].numpy()
            row["valid"] = float(out[2].cpu().numpy().mean())
            row["rot_err_deg_median"] = float(np.median([_angle_deg(a @ b.T) for a, b in zip(R, smp["R"])]))
            # held together where the CPU's solve is within 0.1 deg of the
            # truth: a near-planar sample (DLT) or control points on a flat
            # spread (EPnP) gives each device its own arbitrary solve
            good = np.array([_angle_deg(a @ b.T) < 0.1 for a, b in zip(R_cpu, smp["R"][:n_cpu])])
            diff = np.abs(R[:n_cpu] - R_cpu).reshape(n_cpu, -1).max(-1)[good]
            row["cpu_well_conditioned"] = float(good.mean())
            row["card_cpu_R_diff_median"] = float(np.median(diff)) if len(diff) else 0.0
            row["card_cpu_agree"] = float((diff < 1e-3).mean()) if len(diff) else 1.0
        else:
            k1 = LOC_SOLVER_K1 if name == "p5pfr" else None
            f_card = _recovered_focal(out, smp["focal"], k1)
            f_cpu = _recovered_focal(ref, smp["focal"], k1)
            row["recovered"] = float(np.isfinite(f_card).mean())
            row["recovered_cpu"] = float(np.isfinite(f_cpu).mean())
            same = (np.isnan(f_card[:n_cpu]) & np.isnan(f_cpu)) | (np.abs(f_card[:n_cpu] - f_cpu) < 1e-3 * smp["focal"])
            row["card_cpu_agree"] = float(same.mean())
        rows[name] = row
    return rows


# The main path's float32 null-vector solvers, each on EIGH_SITE_SAMPLES
# noise-free samples of the hard scene's truth at the shapes its callers
# build, on the card and on the CPU: the share each solves (its result within
# EIGH_SITE_TOL of the truth) and the share where the card's result is the
# CPU's (within EIGH_SITE_AGREE). A card's batched float32 eigh lost DLT's
# smallest eigenvector where LAPACK kept it (`numeric.eigh64`).
EIGH_SITE_SAMPLES = 4096
EIGH_SITE_TOL = dict(essential_5pt=1e-3, fundamental_8pt=1e-2, homography_4pt=1.0, triangulate_dlt=1e-3,
                     triangulate_nview=1e-3, average_quaternions=0.1, rotation_averaging_l2=0.5)
EIGH_SITE_AGREE = dict(essential_5pt=1e-3, fundamental_8pt=1e-3, homography_4pt=1e-3, triangulate_dlt=1e-4,
                       triangulate_nview=1e-4, average_quaternions=0.01, rotation_averaging_l2=0.01)
EIGH_VALID_SLACK = 0.002  # the card's valid share may sit this far under the CPU's (float rounding at the tolerance)
EIGH_AVG_FRAMES, EIGH_GRAPH_VIEWS = 8, 12  # a rig's frames; a panorama's views (edges to the next two)


def eigh_site_samples(n: int, seed: int = 1) -> dict:
    """n samples of the hard scene's truth: three ring-neighbouring views i,
    j, k and 8 points all three see; the pinhole pixels and normalized
    coordinates of the points in each, the views' (R, t), a fourth and a
    fifth point on the plane of the first three, and the rotation-graph and
    quaternion inputs drawn from the ring's rotations."""
    from alicevision_tpu_torch.utils.rendered import hard_scene

    hs = hard_scene(HARD_VIEWS, HARD_POINTS)
    rng = np.random.RandomState(seed)
    f, pp = float(hs.K[0, 0]), hs.K[:2, 2]
    t_all = -np.einsum("vij,vj->vi", hs.R, hs.c)
    views, pts = [], []
    while len(views) < n:
        i = rng.randint(HARD_VIEWS)
        v3 = np.array([i, (i + 1 + rng.randint(2)) % HARD_VIEWS, (i + 3) % HARD_VIEWS])
        common = np.nonzero(hs.visible[v3].all(0))[0]
        if len(common) >= 8:
            views.append(v3)
            pts.append(rng.choice(common, 8, replace=False))
    views, pts = np.stack(views), np.stack(pts)
    X = hs.points[pts]  # (n, 8, 3)
    a, b = X[:, 1] - X[:, 0], X[:, 2] - X[:, 0]
    plane = np.stack([X[:, 0], X[:, 1], X[:, 2], X[:, 0] + 0.6 * a + 0.5 * b, X[:, 0] + 0.3 * a + 0.3 * b], 1)
    R, t = hs.R[views], t_all[views]  # (n, 3, 3, 3), (n, 3, 3)

    def project(P, v):
        xc = np.einsum("nij,npj->npi", R[:, v], P) + t[:, v, None]
        return xc[..., :2] / xc[..., 2:], xc

    xn, xc = zip(*(project(X, v) for v in range(3)))
    pl = [project(plane, v)[0] * f + pp for v in range(2)]
    R_rel = R[:, 1] @ np.swapaxes(R[:, 0], -1, -2)
    t_rel = t[:, 1] - np.einsum("nij,nj->ni", R_rel, t[:, 0])
    tx = np.zeros((n, 3, 3))
    tx[:, 0, 1], tx[:, 0, 2], tx[:, 1, 2] = -t_rel[:, 2], t_rel[:, 1], -t_rel[:, 0]
    tx -= np.swapaxes(tx, -1, -2)
    E = tx @ R_rel
    Kinv = np.linalg.inv(hs.K)
    F = Kinv.T @ E @ Kinv
    # a rig's sub-pose seen over EIGH_AVG_FRAMES frames, 1e-3 rad apart, in
    # either quaternion sign; a panorama's rotation graph
    q_true = mat_to_quat(torch.as_tensor(hs.R[views[:, 0]])).numpy()
    dR = so3_exp(torch.as_tensor(rng.normal(0, 1e-3, (n, EIGH_AVG_FRAMES, 3)))).numpy()
    qs = mat_to_quat(torch.as_tensor(dR @ hs.R[views[:, 0]][:, None])).numpy()
    qs = qs * rng.choice([-1.0, 1.0], (n, EIGH_AVG_FRAMES, 1))
    ring = (views[:, :1] + np.arange(EIGH_GRAPH_VIEWS)) % HARD_VIEWS
    Rg = hs.R[ring]  # (n, V, 3, 3)
    edges = np.array([(a_, a_ + d) for d in (1, 2) for a_ in range(EIGH_GRAPH_VIEWS - d)])
    dG = so3_exp(torch.as_tensor(rng.normal(0, 1e-4, (n, len(edges), 3)))).numpy()
    G_rel = dG @ Rg[:, edges[:, 1]] @ np.swapaxes(Rg[:, edges[:, 0]], -1, -2)
    return dict(x1n=xn[0], x2n=xn[1], x3n=xn[2], px1=xn[0] * f + pp, px2=xn[1] * f + pp, X1=xc[0],
                X=X[:, 0], P=np.concatenate([R, t[..., None]], -1), plane1=pl[0], plane2=pl[1], R_rel=R_rel,
                t_rel=t_rel, E=E, F=F, q_true=q_true, qs=qs, R_graph=Rg, edges=edges, G_rel=G_rel)


def _sign_fixed(M: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """M (..., k) scaled to unit norm with the sign that agrees with ref."""
    M = M / np.linalg.norm(M, axis=-1, keepdims=True)
    return M * np.where((M * ref).sum(-1, keepdims=True) < 0, -1.0, 1.0)


def eigh_site_values(smp: dict, device, n: int) -> dict:
    """site -> (ms, per-sample error to the truth (n,) or (n, 8), the value
    compared across devices (n, ...)) of the first n samples on `device`."""
    from alicevision_tpu_torch import multiview as mv
    from alicevision_tpu_torch.misc.rig import average_quaternions
    from alicevision_tpu_torch.sfm.global_sfm import rotation_averaging_l2

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a[:n]), dtype=torch.float32, device=device)

    def timed(fn):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) * 1e3, out

    rows = {}
    ms, (E, ok) = timed(lambda: mv.essential_5pt(t(smp["x1n"])[:, :5], t(smp["x2n"])[:, :5]))
    e = smp["E"][:n].reshape(n, 1, 9)
    cand = _sign_fixed(E.double().cpu().numpy().reshape(n, -1, 9), e)
    err = np.where(ok.cpu().numpy(), np.linalg.norm(cand - e / np.linalg.norm(e, axis=-1, keepdims=True), axis=-1),
                   np.inf)
    best = err.argmin(-1)
    rows["essential_5pt"] = (ms, err.min(-1), cand[np.arange(n), best])
    ms, F = timed(lambda: mv.fundamental_8pt(t(smp["px1"]), t(smp["px2"])))
    f = smp["F"][:n].reshape(n, 9)
    f = f / np.linalg.norm(f, axis=-1, keepdims=True)
    Fv = _sign_fixed(F.double().cpu().numpy().reshape(n, 9), f)
    rows["fundamental_8pt"] = (ms, np.linalg.norm(Fv - f, axis=-1), Fv)
    ms, H = timed(lambda: mv.homography_4pt(t(smp["plane1"])[:, :4], t(smp["plane2"])[:, :4]))
    H = H.double().cpu().numpy()
    p5 = np.einsum("nij,nj->ni", H, np.append(smp["plane1"][:n, 4], np.ones((n, 1)), -1))
    rows["homography_4pt"] = (ms, np.linalg.norm(p5[:, :2] / p5[:, 2:] - smp["plane2"][:n, 4], axis=-1),
                              H.reshape(n, 9) / np.abs(H.reshape(n, 9)).max(-1, keepdims=True))
    # the initial pair's (pairs, points) batch: n pairs of 8 points, 8n
    # matrices (`numeric.eigh` splits a card's batch past its chunk)
    eye34 = torch.eye(3, 4, dtype=torch.float32, device=device)
    P2 = torch.cat([t(smp["R_rel"]), t(smp["t_rel"])[..., None]], -1)
    ms, X = timed(lambda: mv.triangulate_dlt(eye34.expand(P2.shape)[:, None], P2[:, None], t(smp["x1n"]),
                                             t(smp["x2n"])))
    X, X1 = X.double().cpu().numpy().reshape(-1, 3), smp["X1"][:n].reshape(-1, 3)
    rows["triangulate_dlt"] = (ms, np.linalg.norm(X - X1, axis=-1) / np.linalg.norm(X1, axis=-1), X)
    x3 = np.stack([smp["x1n"][:, 0], smp["x2n"][:, 0], smp["x3n"][:, 0]], 1)
    ms, Xn = timed(lambda: mv.triangulate_nview(t(smp["P"]), t(x3)))
    Xn, Xt = Xn.double().cpu().numpy(), smp["X"][:n]
    rows["triangulate_nview"] = (ms, np.linalg.norm(Xn - Xt, axis=-1) / np.linalg.norm(smp["X1"][:n, 0], axis=-1), Xn)
    qs = t(smp["qs"])
    ms, q = timed(lambda: torch.stack([average_quaternions(qs[s]) for s in range(n)]))
    q = _sign_fixed(q.double().cpu().numpy(), smp["q_true"][:n])
    rows["average_quaternions"] = (ms, np.degrees(2 * np.arccos(np.clip(np.abs((q * smp["q_true"][:n]).sum(-1)),
                                                                        0, 1))), q)
    G = t(smp["G_rel"])
    ms, Rg = timed(lambda: torch.stack([rotation_averaging_l2(EIGH_GRAPH_VIEWS, smp["edges"], G[s])
                                        for s in range(n)]))
    Rg = Rg.double().cpu().numpy()
    Rt = smp["R_graph"][:n] @ np.swapaxes(smp["R_graph"][:n, :1], -1, -2)  # the gauge R_0 = I
    ang = np.degrees(np.arccos(np.clip((np.trace(Rg @ np.swapaxes(Rt, -1, -2), axis1=-2, axis2=-1) - 1) / 2,
                                       -1, 1)))
    rows["rotation_averaging_l2"] = (ms, ang.max(-1), Rg.reshape(n, -1))
    return rows


def check_eigh_sites(device, n: int = EIGH_SITE_SAMPLES) -> dict:
    """The main path's null-vector sites on n samples on `device` and on
    the CPU: the share solved within EIGH_SITE_TOL of the truth on each;
    "card_cpu_agree", of the samples the CPU solves the share the card
    solves too (as `check_solvers` holds the resection solvers where the
    CPU's solve is right); "card_cpu_close", of the samples both solve the
    share within EIGH_SITE_AGREE of each other (the 5-point, F and H take
    float64 on a card and LAPACK's float32 on the CPU: `numeric.normal_eigh`)."""
    smp = eigh_site_samples(n)
    card, cpu = eigh_site_values(smp, device, n), eigh_site_values(smp, "cpu", n)
    rows = {}
    for name, (ms, err, val) in card.items():
        cpu_ms, err_cpu, val_cpu = cpu[name]
        tol, agree = EIGH_SITE_TOL[name], EIGH_SITE_AGREE[name]
        ok, ok_cpu = err < tol, err_cpu < tol
        # small angles from differences: an arccos of float32 rotations floors at ~0.02 deg
        if name == "average_quaternions":
            diff = np.degrees(2 * np.linalg.norm(val - val_cpu, axis=-1))
        elif name == "rotation_averaging_l2":
            diff = np.degrees(np.linalg.norm((val - val_cpu).reshape(n, -1, 9), axis=-1).max(-1) / np.sqrt(2))
        else:
            scale = np.linalg.norm(val_cpu, axis=-1) if name.startswith("triangulate") else 1.0
            diff = np.linalg.norm(val - val_cpu, axis=-1) / scale
        both = ok & ok_cpu
        rows[name] = {"samples": int(err.size), "ms": ms, "cpu_ms": cpu_ms, "valid": float(ok.mean()),
                      "valid_cpu": float(ok_cpu.mean()),
                      "card_cpu_agree": float(both.sum() / max(ok_cpu.sum(), 1)),
                      "card_cpu_close": float((diff[both] < agree).mean()) if both.any() else 1.0,
                      "err_median": float(np.median(err)), "err_median_cpu": float(np.median(err_cpu))}
    return rows


def eigh_site_misses(rows: dict) -> list:
    """The null-vector sites' gates: on the card each solves at least the
    CPU's share (less EIGH_VALID_SLACK), and at least LOC_GATES["solver_agree"]
    of the samples the CPU solves."""
    bad = []
    for name, r in rows.items():
        if not (r["valid"] >= r["valid_cpu"] - EIGH_VALID_SLACK and r["card_cpu_agree"] >= LOC_GATES["solver_agree"]):
            bad.append(f"{name}: {r}, expected valid >= the CPU's less {EIGH_VALID_SLACK} and agreement >= "
                       f"{LOC_GATES['solver_agree']}")
    return bad


def eigh_chunked(dev, n: int = 40000, size: int = 4) -> dict:
    """`numeric.eigh` of n > its chunk (a card's batched syev refuses
    32767 matrices at once) random SPD matrices on the card, against the
    CPU: the largest eigenvalue difference relative to the largest
    eigenvalue."""
    from alicevision_tpu_torch.numeric import eigh

    g = torch.Generator().manual_seed(0)
    A = torch.randn(n, size, size, generator=g)
    A = A @ A.transpose(-1, -2) + size * torch.eye(size)
    w = eigh(A.to(dev))[0].cpu()
    w_cpu = eigh(A)[0]
    return {"matrices": n, "max_rel_diff": float((w - w_cpu).abs().max() / w_cpu.abs().max())}


def check_solvers_on_card(dev) -> dict:
    """`check_eigh_sites` and `eigh_chunked` on the card and their gates,
    with their seconds."""
    t0 = time.perf_counter()
    rows = check_eigh_sites(dev)
    chunked = eigh_chunked(dev)
    bad = eigh_site_misses(rows)
    if not chunked["max_rel_diff"] < 1e-5:
        bad.append(f"eigh over {chunked['matrices']} matrices: {chunked}")
    if bad:
        raise RuntimeError("solvers: " + "; ".join(bad))
    return {"sites": rows, "eigh_chunked": chunked, "seconds": time.perf_counter() - t0}


def render_marker_frames(n_frames: int, wh, focal_px: float, n_tags: int = 9, tag_px: int = 96):
    """A tag16h5 board (ids 0..n_tags-1 on a 3-column grid of 0.3-unit tags
    0.45 apart, in the plane z = 0, centred at the origin) seen by n_frames
    pinhole cameras on an arc 2.6 units in front of it, up to 29 deg to the
    side and 15 deg up or down (a plane's focal needs the tilt). Returns (images
    (F, H, W) float32, R (F, 3, 3), c (F, 3), {id: tag centre (3,)})."""
    from scipy import ndimage

    from alicevision_tpu_torch.features.markers import render_apriltag

    side, pitch, cols = 0.3, 0.45, 3
    rows_ = (n_tags + cols - 1) // cols
    ppu = tag_px / side  # board pixels a unit
    W_b = int(round((cols * pitch + 0.3) * ppu))
    H_b = int(round((rows_ * pitch + 0.3) * ppu))
    board = np.ones((H_b, W_b), np.float32)
    centres = {}
    for m in range(n_tags):
        r, cidx = divmod(m, cols)
        x = (cidx - (cols - 1) / 2) * pitch
        y = (r - (rows_ - 1) / 2) * pitch
        centres[m] = np.array([x, y, 0.0])
        u0 = int(round((x - side / 2) * ppu + W_b / 2))
        v0 = int(round((y - side / 2) * ppu + H_b / 2))
        board[v0:v0 + tag_px, u0:u0 + tag_px] = render_apriltag(m, tag_px)
    w, h = wh
    ang = np.linspace(-0.5, 0.5, n_frames)
    c = np.stack([2.6 * np.sin(ang), 0.7 * np.sin(3 * ang + 0.5), -2.6 * np.cos(ang)], axis=-1)
    fwd = -c / np.linalg.norm(c, axis=-1, keepdims=True)
    right = np.cross(np.broadcast_to([0.0, -1.0, 0.0], fwd.shape), fwd)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    R = np.stack([right, np.cross(fwd, right), fwd], axis=-2)
    ys, xs = np.mgrid[0:h, 0:w]
    rays = np.stack([(xs + 0.5 - w / 2) / focal_px, (ys + 0.5 - h / 2) / focal_px, np.ones_like(xs, float)], -1)
    imgs = []
    for Rf, cf in zip(R, c):
        d = rays @ Rf  # world directions
        s = -cf[2] / d[..., 2]
        p = cf + s[..., None] * d
        u = p[..., 0] * ppu + W_b / 2 - 0.5
        v = p[..., 1] * ppu + H_b / 2 - 0.5
        imgs.append(ndimage.map_coordinates(board, [v, u], order=1, cval=1.0).astype(np.float32))
    return np.stack(imgs), R, c, centres


def check_marker_sequence(work: str, device, frames: int = LOC_MARKER["frames"], wh=LOC_MARKER["wh"],
                          focal_px: float = LOC_MARKER["focal_px"]) -> dict:
    """The marker path: rendered tag16h5 frames -> cameraInit ->
    featureExtraction's tag16h5 branch -> localize_by_markers each frame at
    a focal LOC_MARKER["focal0"] off -> refine_sequence (poses + shared
    focal, the tag centres fixed)."""
    from alicevision_tpu_torch.features.markers import MarkerDetection
    from alicevision_tpu_torch.localization import localize_by_markers, refine_sequence

    imgs, R_gt, c_gt, centres = render_marker_frames(frames, wh, focal_px, LOC_MARKER["tags"])
    folder = os.path.join(work, "marker_images")
    os.makedirs(folder, exist_ok=True)
    for k, img in enumerate(imgs):
        np.save(os.path.join(folder, f"m_{k:02d}.npy"), img)
    t0 = time.perf_counter()
    scene = os.path.join(work, "marker_init.sfm")
    stages.camera_init(folder, scene, default_focal_px=focal_px, device=device)
    feats = os.path.join(work, "marker_features")
    stages.feature_extraction(scene, feats, downscale_to=0, describer_types="tag16h5", device=device)
    sc = sfmdata.load(scene)
    f0 = focal_px * LOC_MARKER["focal0"]
    gen = torch.Generator(device=device).manual_seed(0)
    Rs, ts, world, uv, detected = [], [], [], [], []
    for v in range(sc.n_views):
        with np.load(os.path.join(feats, f"{int(sc.view_ids[v])}.tag16h5.npz")) as z:
            ids, xy = z["ids"], z["xy"]
        detected.append(int(len(ids)))
        dets = [MarkerDetection(int(i), p, None, 1.0) for i, p in zip(ids, xy)]
        res = localize_by_markers(gen, dets, centres, f0, (float(wh[0]), float(wh[1])), device=device)
        if not res.success:
            raise RuntimeError(f"marker frame {v}: not localized ({len(ids)} tags)")
        Rs.append(res.R)
        ts.append(-res.R @ res.c)
        world.append(np.stack([centres[int(i)] for i in ids]))
        uv.append(xy)
    M = max(len(x) for x in world)
    pad = lambda a, d: np.stack([np.pad(x, ((0, M - len(x)), (0, 0))) for x in a])  # noqa: E731
    mask = np.stack([np.arange(M) < len(x) for x in world])
    out = refine_sequence(np.stack(Rs), np.stack(ts), pad(world, 3), pad(uv, 2), mask, f0,
                          (wh[0] / 2.0, wh[1] / 2.0), device=device)
    c_est = -np.einsum("fji,fj->fi", out.R.cpu().numpy(), out.t.cpu().numpy())
    # the frames' order is cameraInit's (file names sorted), the render's
    return {"frames": frames, "tags_detected": detected, "focal0": f0, "focal": float(out.focal),
            "focal_true": focal_px, "focal_err_frac": abs(float(out.focal) - focal_px) / focal_px,
            "rms_px": float(out.rms_px),
            "centre_err_max": float(np.linalg.norm(c_est - c_gt, axis=1).max()),
            "seconds": time.perf_counter() - t0}


def run_localization_phase(dev, work: str, sfm: str, feats: str, R_gt: np.ndarray, c_gt: np.ndarray,
                           n_queries: int = LOC_QUERIES, wh=HARD_IMG["wh"], focal_px: float = HARD_IMG["focal_px"],
                           disto=(-0.25, 0.06, -0.005), solver_batch: int = LOC_SOLVER_BATCH,
                           solver_cpu: int = LOC_SOLVER_CPU, marker_frames: int = LOC_MARKER["frames"],
                           sweep_seeds: int = LOC_SWEEP_SEEDS, smi: str = "") -> dict:
    """The localization phase on the reconstruction `sfm` + `feats` of the
    ring whose truth is (R_gt, c_gt) (view v = ring camera v): inputs, the
    CLI chain in this process, the report, the draws of `localization_sweep`
    (sweep_seeds of them), the solvers and the marker sequence, with the SGM
    launches counted from 0. Returns the row."""
    from alicevision_tpu_torch.pipeline.cli import main

    cuda = torch.device(dev).type == "cuda"
    sgm_kernel.launches.update(dict.fromkeys(sgm_kernel.launches, 0))
    t_phase = time.perf_counter()
    loc_work = os.path.join(work, "localization")
    os.makedirs(loc_work, exist_ok=True)
    inputs = make_localization_inputs(loc_work, dev, n_queries, wh, focal_px, disto)
    db_sfm = os.path.join(loc_work, "database.sfm")
    unmatched = with_feature_ids(sfm, feats, db_sfm)
    if unmatched:
        raise RuntimeError(f"localization: {unmatched} observations of {sfm} match no feature of {feats}")
    sfm = db_sfm
    truth_sfm = os.path.join(loc_work, "truth.sfm")
    _truth_scene(sfm, truth_sfm, R_gt, c_gt)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    rows = run_localization_chain(main, localization_chain(loc_work, inputs, sfm, feats, truth_sfm),
                                  extra=("--device", str(dev)), device=dev if cuda else None)
    report = localization_report(loc_work, rows, inputs, sfm, truth_sfm, R_gt, c_gt, dev)
    per_query = {}
    for i, method in enumerate(LOC_CAMERA_RUNS):
        row = rows["cameraLocalization" + (f"#{i + 1}" if i else "")]
        per_query[method] = {step: v / n_queries for step, v in row["step_seconds"].items()}
        per_query[method]["total"] = row["seconds"] / n_queries
    t0 = time.perf_counter()
    sweep = localization_sweep(sfm, feats, inputs, R_gt, c_gt, dev, sweep_seeds)
    sweep_s = time.perf_counter() - t0
    solvers = check_solvers(dev, solver_batch, solver_cpu)
    markers = check_marker_sequence(loc_work, dev, frames=marker_frames)
    return {"card": smi, "queries": n_queries, "wh": list(wh), "render_s": inputs["render_s"],
            "commands": {k: {"seconds": v["seconds"], "device_peak_gib": v["device_peak_gib"]}
                         for k, v in rows.items()},
            "seconds_per_query": per_query, "report": report, "sweep": sweep, "sweep_s": sweep_s,
            "sweep_right": {k: [d["right"] for d in v] for k, v in sweep.items()},
            "solvers": solvers, "markers": markers,
            "sgm_launches": dict(sgm_kernel.launches), "phase_s": time.perf_counter() - t_phase}


def _pose_kind(a, c, rot: float, cen: float) -> str:
    """A query's result from its errors (None: not localized): "right"
    within rot deg and cen of the radius, "wrong" where the pose misses the
    place (LOC_GATES' wrong_rot_deg or wrong_centre_frac off: a wrong pose
    reported as a success), else "imprecise"."""
    g = LOC_GATES
    if a is None:
        return "none"
    if a < rot and c < cen:
        return "right"
    return "wrong" if a >= g["wrong_rot_deg"] or c >= g["wrong_centre_frac"] else "imprecise"


def right_wrong(r: dict, rot: float, cen: float) -> tuple:
    """(queries of `_pose_errors`' row r right, queries wrong), as
    `_pose_kind` sorts them."""
    kinds = [_pose_kind(a, c, rot, cen) for a, c in zip(r["rot_err_deg"], r["centre_err_frac"])]
    return kinds.count("right"), kinds.count("wrong")


def sweep_entry(results: dict, names: list, R_true, c_true, align, C, radius: float, seed: int) -> dict:
    """One draw's reading of a camera run (results as cameraLocalization's
    JSON) at the phase's query gates: the queries right, and each wrong or
    imprecise success with its errors and inliers."""
    pe = _pose_errors(results, names, R_true, c_true, align, C, radius)
    g = LOC_GATES
    out = {"seed": seed, "right": 0, "wrong": [], "imprecise": []}
    for n, a, c in zip(names, pe["rot_err_deg"], pe["centre_err_frac"]):
        kind = _pose_kind(a, c, g["rot_deg"], g["centre_frac"])
        if kind == "right":
            out["right"] += 1
        elif kind != "none":
            out[kind].append({"query": n, "rot_deg": a, "centre_frac": c, "n_inliers": results[n]["n_inliers"]})
    return out


def localization_sweep(db_sfm: str, feats: str, inputs: dict, R_gt, c_gt, dev, seeds: int,
                       runs=LOC_SWEEP_RUNS) -> dict:
    """The phase's cameraLocalization `runs` (`localization_camera_runs`)
    as the port's CLI loops over the queries, for draws k < seeds: the tree
    of VoctreeLocalizer(seed=k), the RANSAC generator seeded k (draw 0 is
    the CLI's). The LOC_2X runs read `db_sfm` scaled (`scaled_database`).
    Returns {run: [sweep_entry of each draw]}."""
    from alicevision_tpu_torch.localization import localize_image
    from alicevision_tpu_torch.localization.voctree_localizer import VoctreeLocalizer
    from alicevision_tpu_torch.pipeline import cli_ext

    sc, sc_2x = sfmdata.load(db_sfm), scale_intrinsics(sfmdata.load(db_sfm))
    align, C = _database_frame(sc, R_gt, c_gt)
    radius = float(np.linalg.norm(c_gt - c_gt.mean(0), axis=1).mean())
    obs_desc = cli_ext._obs_descriptors(sc, feats)
    lm_desc, lm_pts = cli_ext._build_landmark_index_from_features(sc, feats)
    poses = inputs["poses"]
    vlocs, out = {}, {}
    for run, (method, folder, ds, scaled) in localization_camera_runs(inputs).items():
        if run not in runs:
            continue
        db = sc_2x if scaled else sc
        row = db.intrinsics_table(device=dev).row(0)
        fx, wh = float(np.mean(db.scale[:, 0])), (float(db.sizes[0, 0]), float(db.sizes[0, 1]))
        names = cli_ext._list_queries(folder)
        qf = [cli_ext._query_features(os.path.join(folder, n), row, dev, 2048, 1024 if ds is None else ds)
              for n in names]
        out[run] = []
        for seed in range(seeds):
            gen = torch.Generator(device=dev).manual_seed(seed)
            if method == "voctree" and seed not in vlocs:
                vlocs[seed] = VoctreeLocalizer(sc.points, sc.obs_landmark, sc.obs_view, obs_desc, seed=seed,
                                               device=dev)
            res = {}
            for n, (desc, p) in zip(names, qf):
                r = (vlocs[seed].localize(gen, desc, p, fx, wh) if method == "voctree"
                     else localize_image(gen, lm_desc, lm_pts, desc, p, fx, wh, device=dev))
                res[n] = {"success": bool(r.success), "n_inliers": int(r.n_inliers), "R": np.asarray(r.R).tolist(),
                          "c": np.asarray(r.c).tolist()}
            out[run].append(sweep_entry(res, names, poses["R0"], poses["c0"], align, C, radius, seed))
    return out


def rig_tolerances(tilt_deg: float) -> tuple:
    """(deg, fraction of the radius) within which a rig frame is right on a
    reconstruction whose cameras share a tilt of tilt_deg (`_database_frame`).
    rigCalibration calibrates the sub-pose in the truth's frame, while the
    reconstruction's cameras see camera 1 at the tilted sub-pose C R_s Cᵀ:
    the joint solve parts from the truth in proportion to the tilt in both
    packages (PERF.md §6), so the tolerances grow with it above
    LOC_GATES["rig_tilt_deg"], the tilt they were set on."""
    g = LOC_GATES
    s = max(1.0, tilt_deg / g["rig_tilt_deg"])
    return g["rig_rot_deg"] * s, g["rig_centre_frac"] * s


def localization_misses(row: dict) -> list:
    """The phase's gates (LOC_GATES) against its row."""
    g, rep, bad = LOC_GATES, row["report"], []

    for kind, wants, (rot, cen) in (("camera", g["localized"], (g["rot_deg"], g["centre_frac"])),
                                    ("rig", g["rig_frames"], rig_tolerances(rep["database_tilt_deg"]))):
        for method, want in wants.items():
            r = rep[f"{kind}_{method}"]
            right, wrong = right_wrong(r, rot, cen)
            if not (right >= want and wrong <= g["wrong"]):
                bad.append(f"{kind} {method}: {right} of {row['queries']} within {rot} deg and {cen} of the radius, "
                           f"{wrong} wrong ({r}), expected at least {want} and at most {g['wrong']} wrong")
    for method, draws in row["sweep"].items():
        want = g["localized_k"].get(method, 0)
        right = sum(d["right"] for d in draws)
        wrong = [w for d in draws for w in d["wrong"]]
        cli_wrong = right_wrong(rep[f"camera_{method}"], g["rot_deg"], g["centre_frac"])[1]
        if not (right >= want and len(wrong) <= g["wrong"] and cli_wrong <= g["wrong"]):
            bad.append(f"camera {method}: {right} of {row['queries']} x {len(draws)} draws within {g['rot_deg']} deg "
                       f"and {g['centre_frac']} of the radius ({[d['right'] for d in draws]} a draw), wrong {wrong} "
                       f"and {cli_wrong} in the CLI's run, expected at least {want} and at most {g['wrong']} wrong")
    if not (rep["subpose_rot_err_deg"] < g["subpose_rot_deg"] and rep["subpose_centre_err"] < g["subpose_centre"]):
        bad.append(f"rigCalibration: sub-pose {rep['subpose_rot_err_deg']} deg, {rep['subpose_centre_err']}, "
                   f"expected < {g['subpose_rot_deg']}, < {g['subpose_centre']}")
    if not rep["rig_transform_max_centre_err"] < g["subpose_centre"] + 3 * LOC_RIG_NOISE:
        bad.append(f"rigTransform: centres {rep['rig_transform_max_centre_err']} from camera 1's")
    if rep["sfm_to_rig_cameras"] != row["queries"]:
        bad.append(f"sfmToRig: {rep['sfm_to_rig_cameras']} cameras")
    fr = rep["frustum"]
    if not (fr["cli_equals_cpu"] and fr["card_equals_cpu"] and 0 < fr["pairs"] < fr["of"]):
        bad.append(f"frustum pairs: {fr}")
    sm = rep["split_merge"]
    if not (sm["same_ids"] and sm["same_poses"] and len(set(sm["views"])) == 1 and len(set(sm["landmarks"])) == 1
            and len(set(sm["observations"])) == 1):
        bad.append(f"sfmSplitReconstructed -> sfmMerge: {sm}")
    reg = rep["regression_self"]
    # a scene against itself: no centre moves; the angle floors at the
    # arccos of a trace just below 3 (the reference's readings, ~0.05 deg)
    if not (reg["center_dist_max"] == 0.0 and reg["rotation_deg_max"] < 0.1):
        bad.append(f"sfmRegression of a scene against itself: {reg}")
    if not (rep["transfer"]["poses"] >= HARD_IMG_MIN_POSED and rep["apply_calibration"]["intrinsics_updated"] == 1
            and rep["sample_scene"] == {"views": 10, "landmarks": 100}):
        bad.append(f"scene tools: {rep['transfer']}, {rep['apply_calibration']}, {rep['sample_scene']}")
    for name, s in row["solvers"].items():
        if name in ("resection_dlt6", "epnp"):
            if not s["rot_err_deg_median"] < g["linear_rot_deg"]:
                bad.append(f"{name}: {s}")
        elif not s["recovered"] >= g["solver_recovered"]:
            bad.append(f"{name}: {s}")
        if not s["card_cpu_agree"] >= g["solver_agree"]:
            bad.append(f"{name}: the card against the CPU {s}")
    m = row["markers"]
    if not (m["focal_err_frac"] < g["marker_focal"] and m["rms_px"] < g["marker_rms_px"]):
        bad.append(f"marker sequence: {m}")
    if any(row["sgm_launches"].values()):
        bad.append(f"the localization path launched SGM kernels: {row['sgm_launches']}")
    return bad


def save_localization_inputs(db_sfm: str, feats: str, out: str) -> dict:
    """`db_sfm` (a reconstruction with feature ids, `with_feature_ids`) and
    the features its observations name, renumbered per view, into `out`
    (database.sfm, features/<viewId>.feat.npz): what
    scripts/localization_reference.py --inputs reads."""
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


def check_localization(dev, work: str, smi: str, keep: str | None = None) -> tuple:
    """The localization phase on the hard_scene phase's reconstruction, and
    its gates; with `keep`, the reconstruction is saved there first
    (`save_localization_inputs`). Returns (the row, its SGM launches, all 0)."""
    from alicevision_tpu_torch.utils.rendered import _ring_cameras

    _, R_gt, c_gt = _ring_cameras(HARD_VIEWS, 6.0, 1.2, HARD_IMG["focal_px"], HARD_IMG["wh"], 0)
    feats = os.path.join(work, "hard_features")
    row = run_localization_phase(dev, work, os.path.join(work, "hard_sfm.sfm"), feats, R_gt, c_gt, smi=smi)
    if keep:
        print("kept localization inputs: " + json.dumps(save_localization_inputs(
            os.path.join(work, "localization", "database.sfm"), feats, keep)), flush=True)
    bad = localization_misses(row)
    if bad:
        raise RuntimeError("localization: " + "; ".join(bad))
    return row, row["sgm_launches"]


# ------------------------------------------------------------------ calibration

# The calibration phase (after localization): the calibration, distortion,
# colour-chart and photometric-stereo subcommands through `cli.main` in
# this process, as a calibration user shoots: 15 frames of a 9x6-corner
# board at 1920x1080 (pinhole, radial k1, shading, noise) through
# checkerboardDetection -> checkerboardCalibration and cameraCalibration ->
# convertDistortion / exportDistortion -> distortionCalibration; a Macbeth
# chart at 1920x1080 under a gain and an offset through
# colorCheckerDetection -> colorCheckerCorrection; a glossy sphere and a
# textured relief under 12 lights at 2048x1536 through sphereDetection ->
# lightingCalibration -> photometricStereo -> normalIntegration ->
# lightingEstimation (`utils/calibration_scenes.py`, numpy, seeded). A real
# shoot is 24 MP with 20-40 board frames and 10-20 lights. Its gates are on
# the truth, at the JAX chain's readings on the same files
# (scripts/calibration_chain_reference.py, on the CPU); it also holds the
# card's Zhang calibration and photometric stereo to the CPU's on the same
# inputs. None of these modules reaches a Pallas kernel in the JAX package:
# the phase launches no SGM kernel.
CAL_BOARD = dict(n_frames=15, rows=6, cols=9, wh=(1920, 1080), focal_px=1500.0, k1=-0.12)
CAL_CHART = dict(wh=(1920, 1080), patch=120, gain=0.8, offset=0.05)
CAL_PHOTO = dict(wh=(2048, 1536), n_lights=12, sphere_r=300.0)
# The JAX chain's readings on the same files (calibration_chain_reference.py,
# my CPU run), each gate that reading plus an allowance for the float
# rounding between the card and the CPU, stated in the gated quantity's
# units: corners 0.1271 px (+0.008); fx, fy 0.096 px off 1500 (6.4e-5; +0.05
# px), principal point 0.282 px (+0.05), RMS 0.1132 px (+0.005), k1 0.00115
# off (+1e-4, k2 takes the rest); the lines' k1 9.8e-5 off (+1e-4);
# brown's k1..k3 5.9e-8 off its input (float32 LM noise: 1e-6); the distort
# STMap 0.0316 px from the true lens (+0.005); chart centres 0.707 px, the
# corrected colours 0.00026 (host code, the same bits); the sphere 0.488
# px, radius exact (host code); lights 0.773 deg at worst (+0.2: the
# highlight's argmax moving one pixel on the card's blur); normals 0.4743
# deg (+0.025); depth 19.94 px (+0.5, of a 148.6-px relief: 400 CG steps do
# not converge at 2048x1536 in either package); the SH shading residual
# 0.0067 (the port forms its normal equations in float64: 0.0060).
CAL_GATES = dict(
    frames=15, corner_px=0.135,  # frames with all 54 corners found; their median distance to the truth
    focal_frac=1e-4, pp_px=0.34, rms_px=0.12, k1=0.00125,  # cameraCalibration and checkerboardCalibration
    lines_k1=2e-4,  # distortionCalibration: k1 against the truth
    brown=1e-6, stmap_px=0.037,  # convertDistortion's k1..k3 against its input; exportDistortion against the truth
    chart_px=0.75, chart_residual=0.0005,  # patch centres found; corrected colours against the chart's
    sphere_px=0.5, sphere_r_px=0.5,  # sphereDetection: centre and radius
    light_deg=1.0, normal_deg=0.5, depth_px=20.5, sh_residual=0.007,
    card_cpu_K=1e-4, card_cpu_normal_deg=0.01,  # the card against the CPU on the same inputs
)


def make_calibration_inputs(work: str, board_cfg=CAL_BOARD, chart_cfg=CAL_CHART, photo_cfg=CAL_PHOTO) -> dict:
    """The phase's shoots in `work` (.npy images): board/, chart/,
    ps_sphere/ and ps_object/, with their truth and configurations."""
    from alicevision_tpu_torch.utils import calibration_scenes as cs

    t0 = time.perf_counter()
    board = cs.render_board_shoot(**board_cfg)
    chart, centres = cs.render_chart(**chart_cfg)
    photo = cs.render_photometric(**photo_cfg)
    folders = {k: os.path.join(work, k) for k in ("board", "chart", "ps_sphere", "ps_object")}
    for f in folders.values():
        os.makedirs(f, exist_ok=True)
    for k, img in enumerate(board["images"]):
        np.save(os.path.join(folders["board"], f"b_{k:02d}.npy"), img)
    np.save(os.path.join(folders["chart"], "chart.npy"), chart)
    for k in range(photo_cfg["n_lights"]):
        np.save(os.path.join(folders["ps_sphere"], f"l_{k:02d}.npy"), photo["sphere"][k])
        np.save(os.path.join(folders["ps_object"], f"l_{k:02d}.npy"), photo["object"][k])
    del board["images"], photo["sphere"], photo["object"]
    return dict(folders=folders, board=board, chart_centres=centres, photo=photo,
                cfg=dict(board=dict(board_cfg), chart=dict(chart_cfg), photo=dict(photo_cfg)),
                render_s=time.perf_counter() - t0)


def calibrated_scene(calib_json: str, out: str, wh) -> None:
    """A one-view .sfm whose intrinsic is cameraCalibration's K with its
    (k1, k2) as RADIALK3 (k3 = 0)."""
    with open(calib_json) as f:
        c = json.load(f)
    K = np.asarray(c["K"])
    sc = sfmdata.SfMData.empty()
    sc.add_intrinsic(0, wh[0], wh[1], float(K[0, 0]), disto_kind=cam.DISTO_RADIALK3,
                     disto_params=(c["dist"][0], c["dist"][1], 0.0),
                     offset=(float(K[0, 2]) - wh[0] / 2.0, float(K[1, 2]) - wh[1] / 2.0), focal_y_px=float(K[1, 1]))
    sc.add_view(1, 0, wh[0], wh[1])
    sfmdata.save(sc, out)


def calibration_chains(work: str, inputs: dict) -> tuple:
    """(the board and chart chain, the sphere's, then the photometric one
    given the sphere found) as (subcommand, argv) lists."""
    def w(*p):
        return os.path.join(work, *p)

    f, b = inputs["folders"], inputs["board"]
    rc = ["--rows", str(b["rows"]), "--cols", str(b["cols"])]
    r = inputs["cfg"]["photo"]["sphere_r"]
    first = [
        ("checkerboardDetection", ["--input", f["board"], "--output", w("corners.json"), *rc]),
        ("checkerboardCalibration", ["--inputFolder", f["board"], "--output", w("board_calib.json"), *rc]),
        ("cameraCalibration", ["--input", f["board"], "--output", w("calib.json"), *rc, "--squareSize", "1.0"]),
        ("convertDistortion", ["--input", w("calibrated.sfm"), "--output", w("brown.sfm"), "--to", "brown"]),
        ("exportDistortion", ["--input", w("calibrated.sfm"), "--output", w("stmaps")]),
        ("distortionCalibration", ["--input", w("calibrated.sfm"), "--checkerboards", w("corners.json"), "--output",
                                   w("lines.sfm")]),
        ("colorCheckerDetection", ["--input", f["chart"], "--output", w("chart.json")]),
        ("colorCheckerCorrection", ["--input", f["chart"], "--detections", w("chart.json"), "--output",
                                    w("chart_corrected")]),
        ("sphereDetection", ["--input", os.path.join(f["ps_sphere"], "l_00.npy"), "--output", w("sphere.json"),
                             "--minRadius", str(int(2 * r / 3)), "--maxRadius", str(int(4 * r / 3))]),
    ]

    def photometric(sphere):
        return [
            ("lightingCalibration", ["--inputFolder", f["ps_sphere"], "--sphere", ",".join(str(x) for x in sphere),
                                     "--output", w("lights.json")]),
            ("photometricStereo", ["--inputFolder", f["ps_object"], "--lights", w("lights.json"), "--output",
                                   w("ps")]),
            ("normalIntegration", ["--input", w("ps", "normals.npy"), "--output", w("ps", "depth.npy")]),
            ("lightingEstimation", ["--normals", w("ps", "normals.npy"), "--image",
                                    os.path.join(f["ps_object"], "l_00.npy"), "--albedo", w("ps", "albedo.npy"),
                                    "--output", w("sh.json")]),
        ]

    return first, photometric


def run_calibration_chain(main, work: str, inputs: dict, extra=(), device=None) -> dict:
    """The phase's commands through `main`, cameraCalibration's scene
    written for the distortion commands, and the sphere found handed to
    lightingCalibration."""
    first, photometric = calibration_chains(work, inputs)

    def after(name, row):
        if name == "cameraCalibration":
            calibrated_scene(os.path.join(work, "calib.json"), os.path.join(work, "calibrated.sfm"),
                             inputs["board"]["wh"])

    rows = run_chain(main, first, "calibration", extra, device, after)
    with open(os.path.join(work, "sphere.json")) as f:
        sphere = json.load(f)["sphere"]
    if sphere is None:
        raise RuntimeError("calibration: sphereDetection found no sphere")
    rows.update(run_chain(main, photometric(sphere), "calibration", extra, device))
    return rows


def _stmap_px(stmap: np.ndarray, wh) -> np.ndarray:
    """An STMap (H, W, 2) in pixels (t bottom-up to y down)."""
    w, h = wh
    return np.stack([stmap[..., 0] * w, (1.0 - stmap[..., 1]) * h], -1)


def calibration_report(work: str, inputs: dict) -> dict:
    """The chain's outputs against the truth."""
    from alicevision_tpu_torch.misc.color_checker import MACBETH_SRGB
    from alicevision_tpu_torch.photometric.lighting import render_sh
    from alicevision_tpu_torch.utils import calibration_scenes as cs

    def load(name):
        with open(os.path.join(work, name)) as f:
            return json.load(f)

    b = truth = inputs["board"]
    rep = {}
    det = load("corners.json")["detections"]
    errs = [cs.corner_errors(np.asarray(det[f"b_{k:02d}.npy"]), truth["corners"][k], b["rows"], b["cols"])
            for k in range(len(truth["corners"])) if f"b_{k:02d}.npy" in det]
    rep["frames_detected"] = len(errs)
    rep["corner_err_px_median"] = float(np.median(np.concatenate(errs))) if errs else None
    K_t = truth["K"]
    for key, name in (("camera", "calib.json"), ("board", "board_calib.json")):
        c = load(name)
        K = np.asarray(c["K"])
        rep[key] = {"fx": float(K[0, 0]), "fy": float(K[1, 1]), "cx": float(K[0, 2]), "cy": float(K[1, 2]),
                    "focal_err_frac": float(max(abs(K[0, 0] - K_t[0, 0]), abs(K[1, 1] - K_t[1, 1])) / K_t[0, 0]),
                    "pp_err_px": float(np.hypot(K[0, 2] - K_t[0, 2], K[1, 2] - K_t[1, 2])), "rms_px": c["rms"],
                    "k1": c["dist"][0], "k2": c["dist"][1], "k1_err": abs(c["dist"][0] - truth["k1"]),
                    "views": c["n_views"]}
    src, brown, lines = (sfmdata.load(os.path.join(work, n)) for n in ("calibrated.sfm", "brown.sfm", "lines.sfm"))
    rep["brown_kind"] = int(brown.disto_kind[0])
    rep["brown_k_diff"] = float(np.abs(brown.disto[0, :3] - src.disto[0, :3]).max())
    rep["lines_k"] = lines.disto[0, :3].tolist()
    rep["lines_k1_err"] = abs(float(lines.disto[0, 0]) - truth["k1"])
    # exportDistortion's distort map: each pixel's undistorted source, against
    # the true lens (K, k1)
    wh = b["wh"]
    st = _stmap_px(np.load(os.path.join(work, "stmaps", "0_distort_stmap.npy")), wh)
    H, W = st.shape[:2]
    ys, xs = np.mgrid[0:H, 0:W] + 0.5
    xu, yu = cs._undistort_k1((xs * wh[0] / W - K_t[0, 2]) / K_t[0, 0], (ys * wh[1] / H - K_t[1, 2]) / K_t[1, 1],
                              truth["k1"])
    true_src = np.stack([xu * K_t[0, 0] + K_t[0, 2], yu * K_t[1, 1] + K_t[1, 2]], -1)
    rep["stmap_err_px_median"] = float(np.median(np.linalg.norm(st - true_src, axis=-1)))
    rep["stmap_shape"] = list(st.shape)

    chart = load("chart.json")["checkers"].get("chart.npy")
    centres = inputs["chart_centres"]
    if chart is None:
        rep["chart_found"] = False
    else:
        rep["chart_found"] = True
        rep["chart_centre_err_px_median"] = float(np.median(np.linalg.norm(np.asarray(chart["positions"]) - centres,
                                                                            axis=-1)))
        corrected = np.load(os.path.join(work, "chart_corrected", "chart.npy"))
        r = int(0.15 * inputs["cfg"]["chart"]["patch"])
        cols = np.array([corrected[int(cy) - r:int(cy) + r + 1, int(cx) - r:int(cx) + r + 1].reshape(-1, 3).mean(0)
                         for cx, cy in centres])
        rep["chart_residual"] = float(np.abs(cols - MACBETH_SRGB).mean())
        rep["chart_residual_before"] = float(np.abs(np.asarray(chart["colors"]) - MACBETH_SRGB).mean())

    p = inputs["photo"]
    sph = load("sphere.json")["sphere"]
    cx, cy, r = p["sphere_cxr"]
    rep["sphere"] = sph
    rep["sphere_err_px"] = float(np.hypot(sph[0] - cx, sph[1] - cy))
    rep["sphere_r_err_px"] = abs(sph[2] - r)
    L = np.asarray(load("lights.json")["directions"])
    ang = np.degrees(np.arccos(np.clip((L * p["lights"]).sum(-1), -1, 1))) if L.shape == p["lights"].shape else None
    rep["lights"] = int(len(L))
    rep["light_err_deg_max"] = float(ang.max()) if ang is not None else None
    rep["light_err_deg_median"] = float(np.median(ang)) if ang is not None else None
    n = np.load(os.path.join(work, "ps", "normals.npy"))
    nerr = np.degrees(np.arccos(np.clip((n * p["normals"]).sum(-1), -1, 1)))
    rep["normal_err_deg_median"] = float(np.median(nerr))
    z = np.load(os.path.join(work, "ps", "depth.npy"))
    rep["depth_err_px_median"] = float(np.median(np.abs(z - (p["depth"] - p["depth"].mean()))))
    rep["depth_range_px"] = float(np.ptp(p["depth"]))
    sh = torch.as_tensor(np.asarray(load("sh.json")["sh"]), dtype=torch.float64)
    albedo = np.load(os.path.join(work, "ps", "albedo.npy"))
    img = np.load(os.path.join(inputs["folders"]["ps_object"], "l_00.npy"))
    shade = render_sh(torch.as_tensor(n, dtype=torch.float64), sh).numpy() * albedo
    rep["sh_residual"] = float(np.abs(shade - img).mean() / np.abs(img).mean())
    return rep


def calibration_card_cpu(work: str, inputs: dict, dev) -> dict:
    """Zhang calibration on checkerboardDetection's corners and photometric
    stereo on the shoot with lightingCalibration's lights, on the card and on
    the CPU: the largest relative difference of K's entries, and the largest
    angle between the two normal maps."""
    from alicevision_tpu_torch.calibration import calibrate_zhang
    from alicevision_tpu_torch.photometric import photometric_stereo

    b = inputs["board"]
    with open(os.path.join(work, "corners.json")) as f:
        det = json.load(f)["detections"]
    grids = np.stack([np.asarray(det[k]) for k in sorted(det)])
    obj = np.array([[i, j] for j in range(b["rows"]) for i in range(b["cols"])], float)
    Ks = [calibrate_zhang(obj, grids, device=d)["K"] for d in (dev, "cpu")]
    with open(os.path.join(work, "lights.json")) as f:
        L = np.asarray(json.load(f)["directions"])
    folder = inputs["folders"]["ps_object"]
    imgs = np.stack([np.load(os.path.join(folder, n)) for n in sorted(os.listdir(folder))])
    ns = [photometric_stereo(torch.as_tensor(imgs, device=d), torch.as_tensor(L, dtype=torch.float32, device=d))[0]
          .cpu().double().numpy() for d in (dev, "cpu")]
    cosang = np.clip((ns[0] * ns[1]).sum(-1) / np.maximum(np.linalg.norm(ns[0], axis=-1)
                                                          * np.linalg.norm(ns[1], axis=-1), 1e-12), -1, 1)
    return {"K_rel_diff": float(np.abs(Ks[0] - Ks[1]).max() / Ks[1][0, 0]),
            "normal_diff_deg_max": float(np.degrees(np.arccos(cosang)).max())}


def run_calibration_phase(dev, work: str, smi: str = "", board_cfg=CAL_BOARD, chart_cfg=CAL_CHART,
                          photo_cfg=CAL_PHOTO) -> dict:
    """The calibration phase: inputs, the CLI chain in this process, the
    report and the card-vs-CPU check, with the SGM launches counted from 0.
    Returns the row."""
    from alicevision_tpu_torch.pipeline.cli import main

    cuda = torch.device(dev).type == "cuda"
    sgm_kernel.launches.update(dict.fromkeys(sgm_kernel.launches, 0))
    t_phase = time.perf_counter()
    cal_work = os.path.join(work, "calibration")
    os.makedirs(cal_work, exist_ok=True)
    inputs = make_calibration_inputs(cal_work, board_cfg, chart_cfg, photo_cfg)
    rows = run_calibration_chain(main, cal_work, inputs, extra=("--device", str(dev)), device=dev if cuda else None)
    report = calibration_report(cal_work, inputs)
    t0 = time.perf_counter()
    card_cpu = calibration_card_cpu(cal_work, inputs, dev)
    card_cpu["seconds"] = time.perf_counter() - t0
    return {"card": smi, "board": {k: list(v) if isinstance(v, tuple) else v for k, v in board_cfg.items()},
            "photo_wh": list(photo_cfg["wh"]), "render_s": inputs["render_s"],
            "commands": {k: {"seconds": v["seconds"], "device_peak_gib": v["device_peak_gib"]} for k, v in rows.items()},
            "report": report, "card_cpu": card_cpu, "sgm_launches": dict(sgm_kernel.launches),
            "phase_s": time.perf_counter() - t_phase}


def calibration_misses(row: dict) -> list:
    """The phase's gates (CAL_GATES) against its row."""
    g, rep, bad = CAL_GATES, row["report"], []
    if not (rep["frames_detected"] >= g["frames"] and rep["corner_err_px_median"] < g["corner_px"]):
        bad.append(f"checkerboardDetection: {rep['frames_detected']} frames, corners {rep['corner_err_px_median']} "
                   f"px from the truth, expected {g['frames']} and < {g['corner_px']}")
    for key in ("camera", "board"):
        c = rep[key]
        if not (c["focal_err_frac"] < g["focal_frac"] and c["pp_err_px"] < g["pp_px"] and c["rms_px"] < g["rms_px"]
                and c["k1_err"] < g["k1"] and c["views"] >= g["frames"]):
            bad.append(f"{key} calibration: {c}, expected focal < {g['focal_frac']}, principal point < {g['pp_px']} px, "
                       f"RMS < {g['rms_px']} px, k1 within {g['k1']}, {g['frames']} views")
    if not (rep["lines_k1_err"] < g["lines_k1"]):
        bad.append(f"distortionCalibration: k {rep['lines_k']}, expected k1 within {g['lines_k1']} of the truth")
    if not (rep["brown_kind"] == cam.DISTO_BROWN and rep["brown_k_diff"] < g["brown"]):
        bad.append(f"convertDistortion: kind {rep['brown_kind']}, k1..k3 {rep['brown_k_diff']} off, expected < "
                   f"{g['brown']}")
    if not rep["stmap_err_px_median"] < g["stmap_px"]:
        bad.append(f"exportDistortion: {rep['stmap_err_px_median']} px from the true lens, expected < {g['stmap_px']}")
    if not (rep["chart_found"] and rep["chart_centre_err_px_median"] < g["chart_px"]
            and rep["chart_residual"] < g["chart_residual"]):
        bad.append(f"colour chart: {({k: v for k, v in rep.items() if k.startswith('chart')})}, expected centres < "
                   f"{g['chart_px']} px and a corrected residual < {g['chart_residual']}")
    if not (rep["sphere_err_px"] < g["sphere_px"] and rep["sphere_r_err_px"] < g["sphere_r_px"]):
        bad.append(f"sphereDetection: {rep['sphere']}, {rep['sphere_err_px']} px, radius {rep['sphere_r_err_px']} px "
                   f"off, expected < {g['sphere_px']}, < {g['sphere_r_px']}")
    if not (rep["light_err_deg_max"] is not None and rep["light_err_deg_max"] < g["light_deg"]):
        bad.append(f"lightingCalibration: {rep['lights']} lights, {rep['light_err_deg_max']} deg, expected "
                   f"< {g['light_deg']}")
    if not (rep["normal_err_deg_median"] < g["normal_deg"] and rep["depth_err_px_median"] < g["depth_px"]
            and rep["sh_residual"] < g["sh_residual"]):
        bad.append(f"photometric: normals {rep['normal_err_deg_median']} deg, depth {rep['depth_err_px_median']} px, "
                   f"SH residual {rep['sh_residual']}, expected < {g['normal_deg']}, < {g['depth_px']}, "
                   f"< {g['sh_residual']}")
    cc = row["card_cpu"]
    if not (cc["K_rel_diff"] < g["card_cpu_K"] and cc["normal_diff_deg_max"] < g["card_cpu_normal_deg"]):
        bad.append(f"the card against the CPU: {cc}, expected K within {g['card_cpu_K']} and normals within "
                   f"{g['card_cpu_normal_deg']} deg")
    if any(row["sgm_launches"].values()):
        bad.append(f"the calibration path launched SGM kernels: {row['sgm_launches']}")
    return bad


def check_calibration(dev, work: str, smi: str) -> tuple:
    """The calibration phase and its gates. Returns (the row, its SGM
    launches, all 0)."""
    row = run_calibration_phase(dev, work, smi)
    bad = calibration_misses(row)
    if bad:
        raise RuntimeError("calibration: " + "; ".join(bad))
    return row, row["sgm_launches"]


# ----------------------------------------------------------------------- extras

# The extras phase (after the calibration phase): the front-end extras —
# AKAZE (MSURF and MLDB), the homography-growing filter, K-VLD and the
# photometric filter, keyframeSelection — and the subcommands of ROADMAP
# item 13 (a), in this process through `cli.main` and the modules. It runs
# on the dense phase's 8 rendered 1280x960 views and the cli phase's
# DSP-SIFT features, matches, tracks and reconstruction; keyframeSelection
# on a rendered 10-frame sequence with two of every three frames blurred.
# Its readings against the truth are gated at the JAX package's on the same
# images (scripts/front_extras_reference.py, on the CPU: EXTRAS_REFERENCE,
# with the margins of EXTRAS_GATES); the card's outputs are held to the
# CPU's. None of these modules reaches a Pallas kernel in the JAX package:
# the phase launches no SGM kernel.

EXTRAS_PAIR = (0, 1)  # the view pair of the K-VLD and photometric filters
EXTRAS_KEYFRAMES = dict(n_frames=10, wh=(320, 240), focal_px=280.0, arc=0.06, sharp_every=3, blur_sigma=2.0,
                        step=3)
EXTRAS_VOCTREE = dict(neighbors=2, draws=8)  # voctreeQueryUtility's recall of adjacent views, over draws
EXTRAS_COV_ATOL = 1e-3  # computeUncertainty, card against CPU: of the largest entry, and the mean trace (relative)
EXTRAS_CARD_CPU_KEYPOINTS = 0.95  # AKAZE: the CPU's keypoints with a card keypoint at its place and scale
EXTRAS_CARD_CPU_PX = 0.05
EXTRAS_MASK_AGREE = 0.99  # K-VLD and photometric keep masks, card against CPU
# the outputs that must be byte-equal on the card and the CPU (the tree,
# its pairs and the covariances depend on the draw or on float32 sums)
EXTRAS_BYTE_EQUAL = ("keypoints", "matches_svg", "tracks.svg", "middlebury.sfm", "mvstex", "matlab", "maya")
# The JAX package's readings on the same images (scripts/front_extras_reference.py,
# JAX on the CPU): matches over the 28 pairs and their median Sampson distance to
# the truth (px); K-VLD and the photometric filter on EXTRAS_PAIR's putative
# matches; the keyframes; adjacent pairs retrieved over 64 trees, and the
# 0.1 % quantile of an 8-draw total
EXTRAS_REFERENCE = {
    "akaze": {"matches": 598, "median_sampson_px": 1.1369, "frac_within_2px": 0.6773},
    "akaze_mldb": {"matches": 329, "median_sampson_px": 0.93, "frac_within_2px": 0.7447},
    "homography_growing": {"matches": 1345, "median_sampson_px": 0.3069, "frac_within_2px": 0.971},
    "putative": {"kept": 118, "median_sampson_px": 0.3045, "frac_within_2px": 0.9322},
    "kvld": {"kept": 114, "median_sampson_px": 0.2746, "frac_within_2px": 0.9649},
    "photometric": {"kept": 118, "median_sampson_px": 0.3045, "frac_within_2px": 0.9322},
    "keyframes_smart": ["f004.npy", "f007.npy"],
    "keyframes_regular": ["f000.npy", "f003.npy", "f006.npy", "f009.npy"],
    "voctree": {"draws": 64, "adjacent_per_draw_mean": 6.9844, "adjacent_per_draw_min": 6, "of_per_draw": 7, "block": 8},
    "voctree_total_gate": 54,
}
# Gates: a reading may be this much worse than the JAX package's
EXTRAS_GATES = dict(inliers_frac=0.8, sampson_factor=1.5, sampson_slack_px=0.2, kept_frac=0.8)


def extras_front_chain(work: str, init: str, sift_feats: str, pairs: str) -> list:
    """The phase's front commands as (name, argv) over `work`: AKAZE and
    AKAZE-MLDB extraction with F-filtered matching, the homography-growing
    filter on the SIFT features, and EXTRAS_PAIR's putative (photometric)
    matches."""
    def w(*p):
        return os.path.join(work, *p)

    steps = []
    for d in ("akaze", "akaze_mldb"):
        steps += [("featureExtraction", ["--input", init, "--output", w(d), "--describerTypes", d]),
                  ("featureMatching", ["--input", init, "--features", w(d), "--pairs", pairs,
                                       "--output", w(f"{d}_matches.npz")])]
    steps += [("featureMatching", ["--input", init, "--features", sift_feats, "--pairs", pairs,
                                   "--geometric", "homography_growing", "--output", w("hg_matches.npz")]),
              ("featureMatching", ["--input", init, "--features", sift_feats, "--pairs", w("pair.txt"),
                                   "--geometric", "none", "--output", w("putative.npz")])]
    with open(w("pair.txt"), "w") as f:
        f.write(f"{EXTRAS_PAIR[0]} {EXTRAS_PAIR[1]}\n")
    return steps


def extras_front_report(work: str, posed_sfm: str, sift_feats: str, n_views: int) -> dict:
    """AKAZE's keypoints and F-verified matches, and the homography-growing
    filter's matches, against the truth."""
    rep = {}
    for d in ("akaze", "akaze_mldb"):
        feats = [stages.load_features(os.path.join(work, d), v + 1) for v in range(n_views)]
        rep[d] = {"keypoints_per_view": [int(f["valid"].sum()) for f in feats],
                  "desc_dim": int(feats[0]["desc"].shape[1]), "desc_dtype": str(feats[0]["desc"].dtype),
                  **epipolar_stats(posed_sfm, feats, stages.load_matches(os.path.join(work, f"{d}_matches.npz")))}
    feats = [stages.load_features(sift_feats, v + 1) for v in range(n_views)]
    rep["homography_growing"] = epipolar_stats(posed_sfm, feats,
                                                stages.load_matches(os.path.join(work, "hg_matches.npz")))
    return rep


def extras_filter_readings(work: str, image_folder: str, posed_sfm: str, sift_feats: str, kvld, photometric) -> dict:
    """K-VLD and the photometric filter on EXTRAS_PAIR's putative matches:
    `kvld(img1, img2, xy1, xy2)` -> keep mask, `photometric(img1, img2,
    feats1, feats2, pairs)` -> (kept pairs, scores). The keep masks, and
    the Sampson distances of what each keeps."""
    i, j = EXTRAS_PAIR
    pm = stages.load_matches(os.path.join(work, "putative.npz"))[(i, j)]
    fi, fj = (stages.load_features(sift_feats, v + 1) for v in (i, j))
    imgs = [np.load(os.path.join(image_folder, f"{v + 1}.npy")).astype(np.float32) for v in (i, j)]
    F = fundamental_true(posed_sfm, i, j)
    x1, x2 = fi["xy"][pm[:, 0]], fj["xy"][pm[:, 1]]
    d = epipolar_px(F, x1, x2)
    keep_k = np.asarray(kvld(imgs[0], imgs[1], x1, x2), bool)
    kept_p, scores = photometric(imgs[0], imgs[1], fi, fj, pm)
    keep_p = np.isin(np.arange(len(pm)), np.nonzero((pm[:, None] == kept_p[None]).all(-1).any(-1))[0])

    def stats(keep):
        return {"kept": int(keep.sum()), "median_sampson_px": float(np.median(d[keep])) if keep.any() else None,
                "frac_within_2px": float((d[keep] < FRONT_EPI_PX).mean()) if keep.any() else 0.0}

    return {"putative": stats(np.ones(len(pm), bool)), "kvld": stats(keep_k), "photometric": stats(keep_p),
            "masks": {"kvld": keep_k, "photometric": keep_p, "zncc": np.asarray(scores, np.float32)}}


def make_keyframe_sequence(folder: str, cfg=EXTRAS_KEYFRAMES) -> list:
    """A short rendered pan (the box world along a small arc), frames
    f000.npy.. in `folder`; all but every `sharp_every`-th frame (from 1)
    blurred. Returns the sharp flags."""
    from alicevision_tpu_torch.image.filtering import gaussian_blur

    imgs, *_ = render_views(cfg["n_frames"], cfg["wh"], focal_px=cfg["focal_px"], arc=cfg["arc"], seed=0)
    os.makedirs(folder, exist_ok=True)
    sharp = []
    for k, img in enumerate(imgs):
        is_sharp = k % cfg["sharp_every"] == 1
        if not is_sharp:
            img = gaussian_blur(torch.from_numpy(img), cfg["blur_sigma"]).numpy()
        np.save(os.path.join(folder, f"f{k:03d}.npy"), img.astype(np.float32))
        sharp.append(is_sharp)
    return sharp


def keyframe_chain(folder: str, work: str, cfg=EXTRAS_KEYFRAMES) -> list:
    return [("keyframeSelection", ["--inputFolder", folder, "--output", os.path.join(work, "keyframes_smart.txt")]),
            ("keyframeSelection", ["--inputFolder", folder, "--output", os.path.join(work, "keyframes_regular.txt"),
                                   "--method", "regular", "--step", str(cfg["step"])])]


def read_keyframes(work: str) -> dict:
    """The frame names `keyframe_chain` selected, by method."""
    out = {}
    for m in ("smart", "regular"):
        with open(os.path.join(work, f"keyframes_{m}.txt")) as f:
            out[m] = f.read().split()
    return out


def write_middlebury_par(posed_sfm: str, path: str) -> None:
    """A Middlebury `*_par.txt` of a posed scene: each view's image name,
    K, R and t = -R c."""
    sc = sfmdata.load(posed_sfm)
    lines = [str(len(sc.valid_views()))]
    for v in sc.valid_views():
        K, R, c = sc.camera_matrices(v)
        vals = [*K.reshape(-1), *R.reshape(-1), *(-R @ c)]
        lines.append(os.path.basename(sc.view_paths[v]) + " " + " ".join(repr(float(x)) for x in vals))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def extras_tools_chain(work: str, init: str, feats: str, matches: str, tracks: str, recon_sfm: str, par: str,
                       image_folder: str) -> list:
    """The eleven subcommands of item 13 (a) as (name, argv), writing under
    `work`."""
    def w(*p):
        return os.path.join(work, *p)

    return [
        ("exportKeypoints", ["--input", init, "--features", feats, "--output", w("keypoints")]),
        ("exportMatches", ["--input", init, "--features", feats, "--matches", matches, "--output", w("matches_svg")]),
        ("exportTracks", ["--input", init, "--tracks", tracks, "--features", feats, "--output", w("tracks.svg")]),
        ("importMiddlebury", ["--input", par, "--imagesFolder", image_folder, "--output", w("middlebury.sfm")]),
        ("voctreeCreation", ["--features", feats, "--input", init, "--output", w("tree.npz")]),
        ("voctreeStatistics", ["--tree", w("tree.npz")]),
        ("voctreeQueryUtility", ["--tree", w("tree.npz"), "--input", init, "--features", feats,
                                 "--output", w("voctree_pairs.txt"), "--nbNeighbors", str(EXTRAS_VOCTREE["neighbors"])]),
        ("computeUncertainty", ["--input", recon_sfm, "--output", w("covariances.npz")]),
        ("exportMVSTexturing", ["--input", recon_sfm, "--output", w("mvstex")]),
        ("exportMatlab", ["--input", recon_sfm, "--output", w("matlab")]),
        ("exportMeshroomMaya", ["--input", recon_sfm, "--output", w("maya")]),
    ]


def _printing(main, printed: dict):
    """`main` with each command's standard output kept in printed[name]."""
    import contextlib
    import io

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        printed[argv[0]] = buf.getvalue()
        return rc

    return run


def tree_bytes(path: str) -> dict:
    """{relative path: bytes} of every file under `path` (or of the file)."""
    if os.path.isfile(path):
        with open(path, "rb") as f:
            return {"": f.read()}
    out = {}
    for d, _, files in sorted(os.walk(path)):
        for name in sorted(files):
            with open(os.path.join(d, name), "rb") as f:
                out[os.path.relpath(os.path.join(d, name), path)] = f.read()
    return out


def adjacent_recall(pairs: np.ndarray, n_views: int) -> int:
    """How many of the n_views - 1 adjacent view pairs (i, i + 1) of the
    rendered arc are among `pairs`."""
    have = {(int(a), int(b)) for a, b in np.asarray(pairs).reshape(-1, 2)}
    return sum((v, v + 1) in have for v in range(n_views - 1))


def voctree_sweep(init: str, feats: str, dev, draws: int) -> list:
    """voctreeCreation and voctreeQueryUtility (their defaults, the phase's
    --nbNeighbors) on the modules, for generator seeds 0..draws-1 on `dev`:
    the adjacent pairs each draw's tree retrieves."""
    from alicevision_tpu_torch.matching import voctree as vt

    sc = sfmdata.load(init)
    fs = [stages.load_features(feats, int(sc.view_ids[v])) for v in range(sc.n_views)]
    train = torch.from_numpy(np.concatenate([f["desc"][f["valid"]] for f in fs])).to(dev)
    out = []
    for k in range(draws):
        tree = vt.build_voctree(torch.Generator(device=dev).manual_seed(k), train, n_children=8, n_levels=3)
        bows = torch.stack([vt.bow_vector(tree, torch.from_numpy(f["desc"]).to(dev), torch.from_numpy(f["valid"]).to(dev))
                            for f in fs])
        pairs = vt.query_pairs(vt.build_database(tree, bows), n_neighbors=EXTRAS_VOCTREE["neighbors"])
        out.append(adjacent_recall(pairs, sc.n_views))
    return out


def akaze_card_cpu(img: np.ndarray, dev, downscale_to: int = 1024) -> dict:
    """One view's AKAZE features on the CPU and on the card from the same
    image, resized as featureExtraction resizes it: the share of the CPU's
    keypoints with a card keypoint within EXTRAS_CARD_CPU_PX at the same
    scale, and the largest MSURF difference among those at the same
    orientation."""
    from alicevision_tpu_torch.features import akaze

    cfg = akaze.AkazeConfig(max_keypoints=FRONT_MAX_KEYPOINTS)
    a, b = card_cpu_features(img, dev, lambda x: akaze.extract(x, cfg), downscale_to)
    va, vb = a["valid"], b["valid"]
    dxy = np.linalg.norm(a["xy"][va][:, None] - b["xy"][vb][None], axis=-1)
    dxy = np.where(np.isclose(a["scale"][va][:, None], b["scale"][vb][None], rtol=1e-5), dxy, np.inf)
    near, dist = dxy.argmin(1), dxy.min(1)
    same = dist < EXTRAS_CARD_CPU_PX
    dori = np.abs(np.angle(np.exp(1j * (b["orientation"][vb][near] - a["orientation"][va]))))
    turned = same & (dori < 1e-3)
    ddesc = np.abs(b["desc"][vb][near] - a["desc"][va])[turned]
    return {"keypoints_cpu": int(va.sum()), "keypoints_card": int(vb.sum()),
            "frac_matched": float(same.mean()) if len(same) else 0.0,
            "frac_same_orientation": float(turned.mean()) if len(turned) else 0.0,
            "max_desc_diff_same_orientation": float(ddesc.max()) if ddesc.size else None}


def run_extras_phase(dev, work: str, posed_sfm: str, cli_dir: str, image_folder: str, recon_sfm: str | None = None,
                     smi: str = "", kf_cfg=EXTRAS_KEYFRAMES, draws: int = EXTRAS_VOCTREE["draws"]) -> dict:
    """The extras phase on the card `dev` (or on the CPU, for the tests):
    the front commands, the filters, keyframeSelection and the eleven
    subcommands, each of the last three on `dev` and on the CPU, with the
    SGM launches counted from 0. `cli_dir` holds the cli phase's
    cameraInit.sfm, features/, pairs.txt, matches.npz and tracks.npz;
    `recon_sfm` (default its sfm.sfm) a reconstruction. Returns the row."""
    from alicevision_tpu_torch.matching import kvld as tkvld
    from alicevision_tpu_torch.matching.photometric_filter import photometric_filter
    from alicevision_tpu_torch.pipeline.cli import main

    cuda = torch.device(dev).type == "cuda"
    sgm_kernel.launches.update(dict.fromkeys(sgm_kernel.launches, 0))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    ex = os.path.join(work, "extras")
    os.makedirs(ex, exist_ok=True)
    init, feats = os.path.join(cli_dir, "cameraInit.sfm"), os.path.join(cli_dir, "features")
    recon_sfm = recon_sfm or os.path.join(cli_dir, "sfm.sfm")
    n_views = sfmdata.load(init).n_views
    on_dev = ("--device", str(dev))

    rows = run_chain(main, extras_front_chain(ex, init, feats, os.path.join(cli_dir, "pairs.txt")), "extras", on_dev,
                     dev if cuda else None)
    front = extras_front_report(ex, posed_sfm, feats, n_views)
    t0 = time.perf_counter()
    front["akaze_card_cpu"] = akaze_card_cpu(np.load(os.path.join(image_folder, "1.npy")), dev)
    front["akaze_card_cpu"]["seconds"] = time.perf_counter() - t0

    filters = {}
    for tag, d in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        filters[tag] = extras_filter_readings(
            ex, image_folder, posed_sfm, feats,
            lambda *a, d=d: tkvld.kvld_filter(*a, device=d),
            lambda *a, d=d: photometric_filter(*a, device=d))
        filters[tag]["seconds"] = time.perf_counter() - t0
    masks = {tag: filters[tag].pop("masks") for tag in filters}
    filters["agree"] = {k: float((masks["card"][k] == masks["cpu"][k]).mean()) for k in ("kvld", "photometric")}
    filters["zncc_max_abs_diff"] = float(np.abs(masks["card"]["zncc"] - masks["cpu"]["zncc"]).max())

    kf_dir = os.path.join(ex, "frames")
    sharp = make_keyframe_sequence(kf_dir, kf_cfg)
    keyframes = {"sharp": [k for k, s in enumerate(sharp) if s]}
    par = os.path.join(ex, "scene_par.txt")
    write_middlebury_par(posed_sfm, par)
    printed, tool_rows = {}, {}
    for tag, d in (("card", dev), ("cpu", "cpu")):
        out = os.path.join(ex, f"run_{tag}")
        os.makedirs(out, exist_ok=True)
        kr = run_chain(main, keyframe_chain(kf_dir, out, kf_cfg), "extras", ("--device", str(d)),
                       d if cuda and tag == "card" else None)
        keyframes[tag] = read_keyframes(out)
        keyframes[f"{tag}_seconds"] = {k: v["seconds"] for k, v in kr.items()}
        printed[tag] = {}
        tool_rows[tag] = run_chain(_printing(main, printed[tag]),
                                   extras_tools_chain(out, init, feats, os.path.join(cli_dir, "matches.npz"),
                                                      os.path.join(cli_dir, "tracks.npz"), recon_sfm, par,
                                                      image_folder),
                                   "extras", ("--device", str(d)), d if cuda and tag == "card" else None)
    card, cpu = (os.path.join(ex, f"run_{t}") for t in ("card", "cpu"))
    keyframes["equal"] = keyframes["card"]["smart"] == keyframes["cpu"]["smart"] and \
        keyframes["card"]["regular"] == keyframes["cpu"]["regular"]
    differ = [name for name in EXTRAS_BYTE_EQUAL
              if tree_bytes(os.path.join(card, name)) != tree_bytes(os.path.join(cpu, name))]
    # the tree depends on the draw, the covariances on float32 sums
    same_json = [n for n in printed["card"] if not n.startswith(("voctree", "computeUncertainty"))]
    differ += [f"printed {n}" for n in same_json if printed["card"][n] != printed["cpu"][n]]
    with np.load(os.path.join(card, "covariances.npz")) as a, np.load(os.path.join(cpu, "covariances.npz")) as b:
        ids_equal = bool(np.array_equal(a["view_ids"], b["view_ids"]))
        cov_a, cov_b = a["covariances"], b["covariances"]
    cov_diff = float(np.abs(cov_a - cov_b).max() / max(np.abs(cov_b).max(), 1e-30))
    traces = [json.loads(printed[t]["computeUncertainty"])["mean_trace"] for t in ("card", "cpu")]
    tools = {"byte_differ": differ, "covariances": {"views": int(len(cov_a)), "ids_equal": ids_equal,
                                                    "max_diff_of_largest": cov_diff,
                                                    "mean_trace": traces,
                                                    "mean_trace_rel_diff": abs(traces[0] - traces[1]) / max(
                                                        abs(traces[1]), 1e-30),
                                                    "finite": bool(np.isfinite(cov_a).all())},
             "voctree_pairs_adjacent": {t: adjacent_recall(np.loadtxt(os.path.join(ex, f"run_{t}", "voctree_pairs.txt"),
                                                                     dtype=np.int64), n_views)
                                        for t in ("card", "cpu")},
             "seconds": {t: {k: v["seconds"] for k, v in tool_rows[t].items()} for t in tool_rows},
             "device_peak_gib": {k: v["device_peak_gib"] for k, v in tool_rows["card"].items()}}
    t0 = time.perf_counter()
    sweep = voctree_sweep(init, feats, dev, draws)
    tools["voctree_sweep"] = {"draws": draws, "adjacent_per_draw": sweep, "total": int(sum(sweep)),
                              "of": draws * (n_views - 1), "seconds": time.perf_counter() - t0}
    return {"card": smi, "commands": {k: {"seconds": v["seconds"], "device_peak_gib": v["device_peak_gib"]}
                                      for k, v in rows.items()},
            "front": front, "filters": filters, "keyframes": keyframes, "tools": tools,
            "sgm_launches": dict(sgm_kernel.launches),
            "device_peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
            "phase_s": time.perf_counter() - t_phase}


def extras_gates(ref=None) -> dict:
    """Each gate of the phase with the JAX reading it comes from."""
    ref = EXTRAS_REFERENCE if ref is None else ref
    g = EXTRAS_GATES

    def sampson(r):
        return max(g["sampson_factor"] * r, r + g["sampson_slack_px"])

    gates = {}
    for d in ("akaze", "akaze_mldb"):
        r = ref[d]
        gates[d] = {"matches_min": int(g["inliers_frac"] * r["matches"]), "median_sampson_px_max": sampson(
            r["median_sampson_px"]), "jax": {k: r[k] for k in ("matches", "median_sampson_px")}}
    r = ref["homography_growing"]
    gates["homography_growing"] = {"matches_min": int(g["kept_frac"] * r["matches"]),
                                   "median_sampson_px_max": sampson(r["median_sampson_px"]),
                                   "jax": {k: r[k] for k in ("matches", "median_sampson_px")}}
    for k in ("kvld", "photometric"):
        r = ref[k]
        gates[k] = {"median_sampson_px_max": sampson(r["median_sampson_px"]),
                    "jax": {"kept": r["kept"], "median_sampson_px": r["median_sampson_px"],
                            "putative_median_sampson_px": ref["putative"]["median_sampson_px"]}}
    gates["keyframes"] = {"smart": ref["keyframes_smart"], "regular": ref["keyframes_regular"]}
    gates["voctree_adjacent_total_min"] = {"min": ref["voctree_total_gate"], "jax": ref["voctree"]}
    return gates


def extras_misses(row: dict, ref=None) -> list:
    """The phase's gates against its row."""
    gates, bad = extras_gates(ref), []
    f = row["front"]
    for d in ("akaze", "akaze_mldb", "homography_growing"):
        r, gt = f[d], gates[d]
        if not (r["matches"] >= gt["matches_min"] and r["median_sampson_px"] is not None
                and r["median_sampson_px"] <= gt["median_sampson_px_max"]):
            bad.append(f"{d}: {r['matches']} matches at a median Sampson distance of {r['median_sampson_px']} px, "
                       f"expected >= {gt['matches_min']} and <= {gt['median_sampson_px_max']} (JAX {gt['jax']})")
    for d, dim, dtype in (("akaze", 64, "float32"), ("akaze_mldb", 486, "float32")):
        if (f[d]["desc_dim"], f[d]["desc_dtype"]) != (dim, dtype):
            bad.append(f"{d}: descriptors {f[d]['desc_dim']} x {f[d]['desc_dtype']}, expected {dim} x {dtype}")
    cc = f["akaze_card_cpu"]
    if not cc["frac_matched"] >= EXTRAS_CARD_CPU_KEYPOINTS:
        bad.append(f"AKAZE card against CPU: {cc}, expected >= {EXTRAS_CARD_CPU_KEYPOINTS} of the keypoints")
    fl = row["filters"]
    for k in ("kvld", "photometric"):
        r = fl["card"][k]
        if not (r["kept"] > 0 and r["median_sampson_px"] <= gates[k]["median_sampson_px_max"]):
            bad.append(f"{k}: kept {r['kept']} at a median Sampson distance of {r['median_sampson_px']} px, "
                       f"expected <= {gates[k]['median_sampson_px_max']} (JAX {gates[k]['jax']})")
        if not fl["agree"][k] >= EXTRAS_MASK_AGREE:
            bad.append(f"{k}: the card's keep mask agrees with the CPU's on {fl['agree'][k]}, expected >= "
                       f"{EXTRAS_MASK_AGREE}")
    kf = row["keyframes"]
    want = gates["keyframes"]
    if not (kf["equal"] and kf["card"]["smart"] == want["smart"] and kf["card"]["regular"] == want["regular"]):
        bad.append(f"keyframeSelection: card {kf['card']}, CPU {kf['cpu']}, expected the JAX package's {want}")
    t = row["tools"]
    if t["byte_differ"]:
        bad.append(f"the card's outputs differ from the CPU's: {t['byte_differ']}")
    cov = t["covariances"]
    if not (cov["ids_equal"] and cov["finite"] and cov["max_diff_of_largest"] <= EXTRAS_COV_ATOL
            and cov["mean_trace_rel_diff"] <= EXTRAS_COV_ATOL):
        bad.append(f"computeUncertainty card against CPU: {cov}, expected within {EXTRAS_COV_ATOL} of the largest")
    vs = t["voctree_sweep"]
    if not vs["total"] >= gates["voctree_adjacent_total_min"]["min"]:
        bad.append(f"voctreeQueryUtility: {vs['total']} adjacent pairs over {vs['draws']} draws, expected >= "
                   f"{gates['voctree_adjacent_total_min']}")
    if any(row["sgm_launches"].values()):
        bad.append(f"the extras path launched SGM kernels: {row['sgm_launches']}")
    return bad


def check_extras(dev, work: str, smi: str) -> tuple:
    """The extras phase on the dense phase's views and the cli phase's
    outputs, and its gates. Returns (the row, its SGM launches, all 0)."""
    row = run_extras_phase(dev, work, os.path.join(work, "scene.sfm"), os.path.join(work, "cli"),
                           os.path.join(work, "images"), smi=smi)
    row["gates"] = extras_gates()
    bad = extras_misses(row)
    if bad:
        raise RuntimeError("extras: " + "; ".join(bad))
    return row, row["sgm_launches"]


# ---------------------------------------------------------------------------
# the `aux` phase (step 10f): item 13 (d)'s subcommands on the card
# ---------------------------------------------------------------------------
#
# imageMasking over the dense scene's 8 views (folder mode, HSV and Otsu)
# and over a 24 MP photograph (HSV, grown and shrunk by 2); imageSegmentation
# of a 12 MP photograph by the classical sky scorer and by an FCN with the
# layout of torchvision's fcn_resnet50 (random seeded weights) through the
# port's ONNX executor; sfmColorHarmonize of the cli phase's views under
# known gains and offsets; three lidar stations through importE57,
# lidarMerging, lidarDecimating and lidarMeshing. Every command runs on the
# card and on the CPU (the FCN's 63 tiles on the card only: two of its tiles
# are held card against CPU in this process); the files are compared, and
# the readings held to the JAX chain's on the same inputs
# (scripts/aux_reference.py, AUX_REFERENCE). None of these modules reaches a
# Pallas kernel in the JAX package: the phase launches no SGM kernel.

AUX = dict(
    photo_wh=(4000, 3000),  # imageSegmentation's photograph (12 MP)
    mask_photo_wh=(6000, 4000),  # imageMasking's photograph (24 MP)
    views_hsv=("0,0,0.3", "1,1,0.8"),  # the grey views' mid tones
    sky_hsv=("0.5,0.2,0.3", "0.75,1,1"),  # the photograph's sky
    grow_shrink=2,
    fcn=dict(width=64, blocks=(3, 4, 6, 3), classes=21, seed=0),  # torchvision's fcn_resnet50
    fcn_tiles=((0, 0), (-1, -1)),  # the first tile and the last (a 312x416 border tile) of segment_tiled's grid
    gains=dict(gain=(0.7, 1.3), offset=(-0.05, 0.05), seed=0),
    lidar=dict(samples=(1024, 512), cell=0.06, seed=0),
)
AUX_TILE, AUX_OVERLAP = 512, 64  # segment_tiled's defaults
AUX_FCN_LOGIT_TOL = 1e-3  # the card's logits against the CPU's, of the tiles' largest |logit| (TF32 off)
AUX_ROOM = [[-6.0, -6.0, -1.3], [6.0, 6.0, 3.0]]  # the scanners' enclosing room: every ray hits a face
AUX_STATIONS = ((2.8, 0.4, 0.2), (-2.7, 1.9, 0.5), (0.3, -3.1, -0.2))
AUX_E57_YAW_DEG = 30.0  # station 0's pose in its E57 file


def aux_photo(wh, seed: int = 0) -> np.ndarray:
    """A (H, W, 3) float32 photograph: a blue sky with soft clouds over a
    wavy horizon, textured ground below, and pixel noise. Numpy, seeded,
    elementwise (no BLAS sums, so every host makes the same bits); separable
    linear upsampling keeps 24 MP to a few seconds."""
    W, H = wh
    rng = np.random.RandomState(seed)

    def lin(grid, n_out, axis):
        n_in = grid.shape[axis]
        x = (np.arange(n_out, dtype=np.float32) + 0.5) * np.float32(n_in / n_out) - np.float32(0.5)
        i0 = np.clip(np.floor(x).astype(np.int64), 0, n_in - 1)
        f = np.clip(x - i0, 0, 1).astype(np.float32)
        f = f[:, None] if axis == 0 else f[None, :]
        return (1 - f) * np.take(grid, i0, axis) + f * np.take(grid, np.minimum(i0 + 1, n_in - 1), axis)

    def smooth(gh, gw):
        return lin(lin(rng.rand(gh, gw).astype(np.float32), H, 0), W, 1)

    v = (np.arange(H, dtype=np.float32) / H)[:, None]
    u = (np.arange(W, dtype=np.float32) / W)[None, :]
    horizon = 0.45 + 0.05 * np.sin(2 * np.pi * 1.5 * u + 0.3) + 0.02 * np.sin(2 * np.pi * 5 * u)
    sky = v < horizon
    s = np.clip(v / horizon, 0, 1)[..., None]
    img = (1 - s) * np.array([0.25, 0.45, 0.85], np.float32) + s * np.array([0.6, 0.75, 0.95], np.float32)
    cloud = np.clip((smooth(12, 16) - 0.55) * 2.5, 0, 1)[..., None]
    img = img * (1 - cloud) + 0.95 * cloud
    t = (0.6 * smooth(48, 64) + 0.4 * smooth(192, 256))[..., None]
    ground = np.array([0.35, 0.3, 0.15], np.float32) + t * np.array([0.3, 0.25, 0.1], np.float32)
    img = np.where(sky[..., None], img, ground) + 0.02 * (rng.rand(H, W, 3).astype(np.float32) - 0.5)
    return np.clip(img, 0, 1).astype(np.float32)


def fcn_resnet50_onnx(path: str, width: int = 64, blocks=(3, 4, 6, 3), classes: int = 21, seed: int = 0) -> dict:
    """Write an `.onnx` with the layout of torchvision's fcn_resnet50 (from
    seeded numpy weights, the port's `make_model`): a ResNet-50 with
    dilation in its last two stages (output stride 8), the 2048->512 3x3
    head and the 1024->256 auxiliary head, `classes` classes each, both
    resized x8 (bilinear). Conv, BatchNormalization, Relu, MaxPool with
    explicit strides, Add, Dropout, Resize; `width` 64 and `blocks` (3, 4,
    6, 3) are the published sizes (35.3 M parameters, 35.4 M weights with
    the BatchNorm statistics). Returns the file's sha256 and its count of
    weights."""
    import hashlib

    from alicevision_tpu_torch.utils.onnx_rt import make_model, make_node

    rng = np.random.RandomState(seed)
    nodes, inits = [], {}

    def conv(x, c_in, c_out, k, stride=1, dil=1, bias=False, name=""):
        w = name + "_w"
        inits[w] = (rng.randn(c_out, c_in, k, k) * np.sqrt(2.0 / (c_in * k * k))).astype(np.float32)
        if bias:  # the classifier: zero mean over its (positive) inputs, so the labels follow the image
            inits[w] -= inits[w].mean(axis=(1, 2, 3), keepdims=True)
        ins = [x, w]
        if bias:
            inits[name + "_b"] = (0.01 * rng.randn(c_out)).astype(np.float32)
            ins.append(name + "_b")
        p = dil * (k - 1) // 2
        nodes.append(make_node("Conv", ins, [name], kernel_shape=[k, k], strides=[stride, stride],
                               dilations=[dil, dil], pads=[p, p, p, p]))
        return name

    def bn(x, c, gamma=1.0, name=""):
        inits[name + "_s"] = (gamma * rng.uniform(0.5, 1.0, c)).astype(np.float32)
        inits[name + "_b"] = (0.1 * rng.randn(c)).astype(np.float32)
        inits[name + "_m"] = (0.1 * rng.randn(c)).astype(np.float32)
        inits[name + "_v"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        nodes.append(make_node("BatchNormalization", [x] + [name + s for s in ("_s", "_b", "_m", "_v")], [name],
                               epsilon=1e-5))
        return name

    def relu(x, name):
        nodes.append(make_node("Relu", [x], [name]))
        return name

    def block(x, c_in, planes, stride, dil, down, name):
        c_out = 4 * planes
        y = relu(bn(conv(x, c_in, planes, 1, name=name + "_c1"), planes, name=name + "_n1"), name + "_r1")
        y = relu(bn(conv(y, planes, planes, 3, stride, dil, name=name + "_c2"), planes, name=name + "_n2"), name + "_r2")
        # a small last gain keeps the random residual stack's activations bounded
        y = bn(conv(y, planes, c_out, 1, name=name + "_c3"), c_out, gamma=0.3, name=name + "_n3")
        if down:
            x = bn(conv(x, c_in, c_out, 1, stride, name=name + "_dc"), c_out, name=name + "_dn")
        nodes.append(make_node("Add", [y, x], [name + "_add"]))
        return relu(name + "_add", name + "_out"), c_out

    x = relu(bn(conv("input", 3, width, 7, 2, name="stem"), width, name="stem_n"), "stem_r")
    p = x + "_pool"
    nodes.append(make_node("MaxPool", [x], [p], kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1]))
    x, c, dil = p, width, 1
    stages = []
    for s, (n, stride) in enumerate(zip(blocks, (1, 2, 2, 2))):
        planes = width * 2 ** s
        first_dil, d = dil, dil
        if s >= 2:  # replace_stride_with_dilation=[False, True, True]
            d, stride = dil * stride, 1
        for b in range(n):
            x, c_new = block(x, c, planes, stride if b == 0 else 1, first_dil if b == 0 else d,
                             b == 0 and (stride != 1 or c != 4 * planes), f"l{s + 1}b{b}")
            c = c_new
        dil = d
        stages.append((x, c))

    def head(x, c_in, name):
        mid = c_in // 4
        y = relu(bn(conv(x, c_in, mid, 3, name=name + "_c"), mid, name=name + "_n"), name + "_r")
        nodes.append(make_node("Dropout", [y], [name + "_d"]))
        y = conv(name + "_d", mid, classes, 1, bias=True, name=name + "_cls")
        nodes.append(make_node("Resize", [y, "", "up8"], [name + "_up"], mode="linear"))
        return name + "_up"

    inits["up8"] = np.asarray([1.0, 1.0, 8.0, 8.0], np.float32)
    out = head(stages[3][0], stages[3][1], "head")
    aux = head(stages[2][0], stages[2][1], "aux")
    data = make_model(nodes, [("input", (1, 3, 512, 512))], [(out, (1, classes, 512, 512)),
                                                             (aux, (1, classes, 512, 512))], inits,
                      graph_name="fcn_resnet50")
    with open(path, "wb") as f:
        f.write(data)
    return {"sha256": hashlib.sha256(data).hexdigest(), "weights": int(sum(v.size for k, v in inits.items()
                                                                            if k != "up8"))}


def tile_grid(hw, tile: int = AUX_TILE, overlap: int = AUX_OVERLAP) -> list:
    """segment_tiled's tiles of an (H, W) image as (y0, y1, x0, x1)."""
    H, W = hw
    step = tile - overlap
    return [(y0, min(y0 + tile, H), x0, min(x0 + tile, W))
            for y0 in range(0, max(H - overlap, 1), step) for x0 in range(0, max(W - overlap, 1), step)]


def fcn_tiles(photo: np.ndarray, picks=AUX["fcn_tiles"]) -> list:
    """The picked tiles of segment_tiled's grid as NCHW float32 inputs."""
    H, W = photo.shape[:2]
    ys = sorted({t[0] for t in tile_grid((H, W))})
    xs = sorted({t[2] for t in tile_grid((H, W))})
    out = []
    for iy, ix in picks:
        y0, x0 = ys[iy], xs[ix]
        t = photo[y0:min(y0 + AUX_TILE, H), x0:min(x0 + AUX_TILE, W), :3]
        out.append(np.ascontiguousarray(np.transpose(t, (2, 0, 1))[None]))
    return out


def label_counts(logits: np.ndarray, classes: int) -> list:
    """Per-class counts of the argmax labels of (1, K, h, w) logits."""
    return np.bincount(np.argmax(logits[0], axis=0).reshape(-1), minlength=classes).tolist()


def lidar_scan(origin, samples, seed: int) -> np.ndarray:
    """One scanner station: `samples` (azimuth, elevation) rays over 360 x
    120 degrees (elevation -60..60), ray-cast against the box world of
    `utils/rendered.py` inside AUX_ROOM, with 2 mm of range noise. Returns
    the (n_az * n_el, 3) hits in world coordinates, float64."""
    from alicevision_tpu_torch.utils.rendered import _ray_box_t, default_boxes

    n_az, n_el = samples
    az = (np.arange(n_az) + 0.5) * 2 * np.pi / n_az
    el = np.deg2rad(-60.0 + (np.arange(n_el) + 0.5) * 120.0 / n_el)
    A, E = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.cos(E) * np.cos(A), np.cos(E) * np.sin(A), np.sin(E)], -1).reshape(-1, 3)
    o = np.asarray(origin, np.float64)
    boxes = np.concatenate([default_boxes(), np.asarray([AUX_ROOM])])
    t = _ray_box_t(np.broadcast_to(o, d.shape), d, boxes).min(-1)
    t = t + 0.002 * np.random.RandomState(seed).randn(len(t))
    return o + t[:, None] * d


def make_lidar_inputs(work: str, samples=AUX["lidar"]["samples"], seed: int = AUX["lidar"]["seed"]) -> dict:
    """The lidar chain's inputs under `work`/lidar_in: station 0 as an E57
    in its scanner frame with its pose (AUX_E57_YAW_DEG about z, its
    position), stations 1 and 2 as PLYs in world coordinates, and an input
    set mixing the three. Returns their paths and the stations."""
    from alicevision_tpu_torch.image.e57 import write_e57
    from alicevision_tpu_torch.mvs.lidar import save_cloud_ply

    d = os.path.join(work, "lidar_in")
    os.makedirs(d, exist_ok=True)
    scans = [lidar_scan(o, samples, seed + k) for k, o in enumerate(AUX_STATIONS)]
    half = np.deg2rad(AUX_E57_YAW_DEG) / 2
    q = (float(np.cos(half)), 0.0, 0.0, float(np.sin(half)))
    c, s = np.cos(2 * half), np.sin(2 * half)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    t = np.asarray(AUX_STATIONS[0], np.float64)
    e57 = os.path.join(d, "station0.e57")
    write_e57(e57, (scans[0] - t) @ R, pose=(q, t))
    entries = [{"ply": "station0.e57"}]
    for k in (1, 2):
        save_cloud_ply(os.path.join(d, f"station{k}.ply"), scans[k])
        entries.append({"ply": f"station{k}.ply", "origin": list(AUX_STATIONS[k])})
    input_set = os.path.join(d, "input_set.json")
    with open(input_set, "w") as f:
        json.dump(entries, f)
    return {"e57": e57, "input_set": input_set, "points_per_station": [len(p) for p in scans]}


def lidar_chain(work: str, inputs: dict, cell: float) -> list:
    """importE57 -> lidarMerging -> lidarDecimating -> lidarMeshing under
    `work`, as (name, argv)."""
    def w(*p):
        return os.path.join(work, *p)

    return [
        ("importE57", ["--input", inputs["e57"], "--output", w("imported.json")]),
        ("lidarMerging", ["--input", inputs["input_set"], "--output", w("merged.ply"), "--outputOrigins",
                          w("merged_origins.npy")]),
        ("lidarDecimating", ["--input", w("merged.ply"), "--origins", w("merged_origins.npy"), "--output",
                             w("decimated.ply"), "--outputOrigins", w("decimated_origins.npy"), "--cellSize", str(cell)]),
        ("lidarMeshing", ["--input", w("decimated.ply"), "--origins", w("decimated_origins.npy"), "--output",
                          w("mesh.obj")]),
    ]


def lidar_report(run_dir: str, printed: dict) -> dict:
    """The chain's counts and its mesh's distance to the box world's faces
    (the room's too)."""
    from alicevision_tpu_torch.mesh import load_obj
    from alicevision_tpu_torch.utils.rendered import default_boxes

    v, f = load_obj(os.path.join(run_dir, "mesh.obj"))
    boxes = np.concatenate([default_boxes(), np.asarray([AUX_ROOM])])
    dist = box_surface_distance(np.asarray(v, np.float64), boxes)
    return {"imported": json.loads(printed["importE57"]), "merged": json.loads(printed["lidarMerging"]),
            "decimated": json.loads(printed["lidarDecimating"]), "mesh": json.loads(printed["lidarMeshing"]),
            "mesh_median_box_distance": float(np.median(dist)), "mesh_p90_box_distance": float(np.quantile(dist, 0.9))}


def masking_chain(work: str, image_folder: str, photo: str, cfg=AUX) -> list:
    """imageMasking: HSV and Otsu over the views' folder, and the sky of the
    24 MP photograph grown and shrunk, under `work`, as (name, argv)."""
    def w(*p):
        return os.path.join(work, *p)

    k = str(cfg["grow_shrink"])
    return [
        ("imageMasking", ["--input", image_folder, "--output", w("views_hsv"), "--hsvMin", cfg["views_hsv"][0],
                          "--hsvMax", cfg["views_hsv"][1]]),
        ("imageMasking", ["--input", image_folder, "--output", w("views_auto"), "--algorithm",
                          "autoGrayscaleThreshold"]),
        ("imageMasking", ["--input", photo, "--output", w("photo_sky_mask.png"), "--hsvMin", cfg["sky_hsv"][0],
                          "--hsvMax", cfg["sky_hsv"][1], "--growRadius", k, "--shrinkRadius", k]),
    ]


def mask_counts(work: str) -> dict:
    """The foreground pixels of each mask the masking chain wrote, and the
    masks themselves."""
    from alicevision_tpu_torch.image.io import read_image

    masks = {}
    for sub in ("views_hsv", "views_auto"):
        for f in sorted(os.listdir(os.path.join(work, sub))):
            masks[f"{sub}/{f}"] = read_image(os.path.join(work, sub, f)) > 0.5
    masks["photo_sky_mask.png"] = read_image(os.path.join(work, "photo_sky_mask.png")) > 0.5
    return masks


def gained_scene(cli_dir: str, out: str, cfg=AUX["gains"]) -> dict:
    """The cli phase's views under known gains and offsets: each image
    times g_v plus o_v (view 0 too), clipped to [0, 1], as `.npy` under
    `out`, and cameraInit.sfm with its views pointing there. Returns the
    scene's path, the gains and offsets, and the clean images' paths."""
    sc = sfmdata.load(os.path.join(cli_dir, "cameraInit.sfm"))
    rng = np.random.RandomState(cfg["seed"])
    g = rng.uniform(*cfg["gain"], sc.n_views)
    o = rng.uniform(*cfg["offset"], sc.n_views)
    os.makedirs(out, exist_ok=True)
    clean = list(sc.view_paths)
    paths = []
    for v in range(sc.n_views):
        img = np.load(clean[v]).astype(np.float32)
        p = os.path.join(out, os.path.basename(clean[v]))
        np.save(p, np.clip(img * np.float32(g[v]) + np.float32(o[v]), 0.0, 1.0).astype(np.float32))
        paths.append(p)
    sc.view_paths = paths
    sfm = os.path.join(out, "gained.sfm")
    sfmdata.save(sc, sfm)
    return {"sfm": sfm, "gain": g.tolist(), "offset": o.tolist(), "clean": clean, "view_ids": sc.view_ids.tolist()}


def harmonize_recovery(out_dir: str, gained: dict) -> dict:
    """How well sfmColorHarmonize's images undo the gains: each output
    fitted as a_v * clean + b_v over its unclipped pixels; with view 0 the
    gauge, a_v / a_0 - 1 and b_v - b_0 are the errors left."""
    from alicevision_tpu_torch.image.io import read_image

    a, b = [], []
    for vid, clean in zip(gained["view_ids"], gained["clean"]):
        h = read_image(os.path.join(out_dir, f"{int(vid)}.png")).astype(np.float64).reshape(-1)
        x = np.load(clean).astype(np.float64).reshape(-1)
        ok = (h > 0.02) & (h < 0.98)
        A = np.stack([x[ok], np.ones(ok.sum())], 1)
        (av, bv), *_ = np.linalg.lstsq(A, h[ok], rcond=None)
        a.append(av)
        b.append(bv)
    rel = np.asarray(a) / a[0] - 1.0
    off = np.asarray(b) - b[0]
    return {"gain_rel_err": rel.tolist(), "offset_err": off.tolist(), "max_gain_rel_err": float(np.abs(rel).max()),
            "max_offset_err": float(np.abs(off).max()), "unharmonized_max_gain_rel_err": float(
                np.abs(np.asarray(gained["gain"]) / gained["gain"][0] - 1).max())}


def fcn_tile_readings(fcn_path: str, photo: np.ndarray, dev, classes: int) -> dict:
    """The FCN on the picked tiles on `dev` and on the CPU, in this process:
    the largest logit difference against the tiles' largest |logit|, the
    share of pixels whose argmax labels agree, and each side's per-class
    label counts."""
    from alicevision_tpu_torch.utils.onnx_rt import OnnxModel

    tiles = fcn_tiles(photo)
    out = {"tiles": [list(t.shape[2:]) for t in tiles]}
    logits = {}
    for tag, d in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        net = OnnxModel(fcn_path, device=d)
        logits[tag] = [net(t)[0].cpu().numpy() for t in tiles]  # output 0: the main head
        out[f"{tag}_seconds"] = time.perf_counter() - t0
        out[f"{tag}_label_counts"] = [label_counts(z, classes) for z in logits[tag]]
    scale = max(float(np.abs(z).max()) for z in logits["cpu"])
    diff = max(float(np.abs(a - b).max()) for a, b in zip(logits["card"], logits["cpu"]))
    agree = [float((np.argmax(a[0], 0) == np.argmax(b[0], 0)).mean()) for a, b in zip(logits["card"], logits["cpu"])]
    out.update(logit_scale=scale, max_abs_logit_diff=diff, max_rel_logit_diff=diff / scale, label_agreement=agree)
    return out


def run_aux_phase(dev, work: str, cli_dir: str, image_folder: str, smi: str = "", cfg=AUX) -> dict:
    """The aux phase on the card `dev` (or on the CPU, for the tests): its
    inputs under `work`/aux, each command through `cli.main` on `dev` and on
    the CPU (the FCN's segmentation on `dev` only), with the SGM launches
    counted from 0. `cli_dir` holds the cli phase's cameraInit.sfm,
    features/ and matches.npz; `image_folder` the dense scene's views.
    Returns the row."""
    from alicevision_tpu_torch.image.io import read_image
    from alicevision_tpu_torch.misc import segmentation
    from alicevision_tpu_torch.pipeline.cli import main

    cuda = torch.device(dev).type == "cuda"
    sgm_kernel.launches.update(dict.fromkeys(sgm_kernel.launches, 0))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    ax = os.path.join(work, "aux")
    os.makedirs(ax, exist_ok=True)

    t0 = time.perf_counter()
    photo = aux_photo(cfg["photo_wh"], seed=0)
    photo_path, photo24 = os.path.join(ax, "photo.npy"), os.path.join(ax, "photo24.npy")
    np.save(photo_path, photo)
    np.save(photo24, aux_photo(cfg["mask_photo_wh"], seed=1))
    fcn_path = os.path.join(ax, "fcn_resnet50.onnx")
    fcn = fcn_resnet50_onnx(fcn_path, **cfg["fcn"])
    lidar_in = make_lidar_inputs(ax, cfg["lidar"]["samples"], cfg["lidar"]["seed"])
    gained = gained_scene(cli_dir, os.path.join(ax, "gained"), cfg["gains"])
    inputs_s = time.perf_counter() - t0

    rows, printed = {}, {}
    for tag, d in (("card", dev), ("cpu", "cpu")):
        out = os.path.join(ax, f"run_{tag}")
        os.makedirs(out, exist_ok=True)
        chain = masking_chain(out, image_folder, photo24, cfg)
        chain.append(("sfmColorHarmonize", ["--input", gained["sfm"], "--features", os.path.join(cli_dir, "features"),
                                            "--matches", os.path.join(cli_dir, "matches.npz"), "--imagesFolder",
                                            os.path.dirname(gained["sfm"]), "--output", os.path.join(out, "harmonized")]))
        chain += lidar_chain(out, lidar_in, cfg["lidar"]["cell"])
        if tag == "card":
            chain += [("imageSegmentation", ["--input", photo_path, "--output", os.path.join(out, "sky_mask.png")]),
                      ("imageSegmentation", ["--input", photo_path, "--modelPath", fcn_path, "--output",
                                             os.path.join(out, "fcn_mask.png")])]
        printed[tag] = {}
        # the scores imageSegmentation computes, kept as it computes them
        scores, tiled = [], segmentation.segment_tiled

        def keeping(*a, **k):
            scores.append(tiled(*a, **k))
            return scores[-1]

        segmentation.segment_tiled = keeping
        try:
            rows[tag] = run_chain(_printing(main, printed[tag]), chain, "aux", ("--device", str(d)),
                                  d if cuda and tag == "card" else None)
        finally:
            segmentation.segment_tiled = tiled
        if tag == "card":
            labels = np.argmax(scores[-1], axis=-1)  # the FCN's, over the whole photograph
            del scores
    card, cpu = (os.path.join(ax, f"run_{t}") for t in ("card", "cpu"))

    masks = {t: mask_counts(os.path.join(ax, f"run_{t}")) for t in ("card", "cpu")}
    mask_row = {"counts": {k: int(m.sum()) for k, m in masks["card"].items()},
                "pixels": {k: int(m.size) for k, m in masks["card"].items()},
                "card_cpu_differ": sorted(k for k in masks["card"] if not np.array_equal(masks["card"][k],
                                                                                          masks["cpu"].get(k)))}
    harm = {t: harmonize_recovery(os.path.join(ax, f"run_{t}", "harmonized"), gained) for t in ("card", "cpu")}
    harm["card_cpu_max_abs_diff"] = max(
        float(np.abs(read_image(os.path.join(card, "harmonized", f)) - read_image(os.path.join(cpu, "harmonized", f))).max())
        for f in sorted(os.listdir(os.path.join(card, "harmonized"))))
    harm["true"] = {"gain": gained["gain"], "offset": gained["offset"]}

    lidar_files = ["imported.json", "imported_scan0.ply", "merged.ply", "merged_origins.npy", "decimated.ply",
                   "decimated_origins.npy", "mesh.obj"]
    lidar = lidar_report(card, printed["card"])
    lidar["card_cpu_differ"] = [f for f in lidar_files
                                if tree_bytes(os.path.join(card, f)) != tree_bytes(os.path.join(cpu, f))]
    lidar["printed_differ"] = [n for n in ("importE57", "lidarMerging", "lidarDecimating", "lidarMeshing")
                               if printed["card"][n] != printed["cpu"][n]]
    lidar["points_per_station"] = lidar_in["points_per_station"]

    # the FCN's labels over the whole photograph (the CLI masks class 0),
    # and two of its tiles card against CPU
    classes = cfg["fcn"]["classes"]
    fcn_mask = read_image(os.path.join(card, "fcn_mask.png")) > 0.5
    seg = {"sky_classical_count": int((read_image(os.path.join(card, "sky_mask.png")) > 0.5).sum()),
           "fcn": {**fcn, "image": list(photo.shape[:2]), "tiles_in_grid": len(tile_grid(photo.shape[:2])),
                   "label_counts": np.bincount(labels.reshape(-1), minlength=classes).tolist(),
                   "mask_count": int(fcn_mask.sum()), "mask_is_class0": bool(np.array_equal(fcn_mask, labels == 0)),
                   "tiles": fcn_tile_readings(fcn_path, photo, dev, classes)}}
    commands = {t: {k: {"seconds": v["seconds"], "device_peak_gib": v["device_peak_gib"]} for k, v in rows[t].items()}
                for t in rows}
    return {"card": smi, "inputs_s": inputs_s, "commands": commands, "masks": mask_row, "segmentation": seg,
            "harmonize": harm, "lidar": lidar, "sgm_launches": dict(sgm_kernel.launches),
            "device_peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
            "phase_s": time.perf_counter() - t_phase}


# The JAX chain's readings on the same inputs (scripts/aux_reference.py, JAX
# on the CPU; the features and matches of the harmonization are its own
# cli front's): the masks' foreground counts, the sky scorer's, the FCN
# file's sha256 and its two tiles' per-class label counts (with the port's
# CPU logits against JAX's there), the harmonization's recovery, and the
# lidar chain's counts and mesh.
AUX_REFERENCE = {
    "mask_counts": {
        "views_hsv/1_mask.png": 1176540,
        "views_hsv/2_mask.png": 1175273,
        "views_hsv/3_mask.png": 1174300,
        "views_hsv/4_mask.png": 1174276,
        "views_hsv/5_mask.png": 1174214,
        "views_hsv/6_mask.png": 1175905,
        "views_hsv/7_mask.png": 1176035,
        "views_hsv/8_mask.png": 1177495,
        "views_auto/1_mask.png": 1083416,
        "views_auto/2_mask.png": 1079338,
        "views_auto/3_mask.png": 1076484,
        "views_auto/4_mask.png": 1078454,
        "views_auto/5_mask.png": 1079122,
        "views_auto/6_mask.png": 1083640,
        "views_auto/7_mask.png": 1084587,
        "views_auto/8_mask.png": 1085839,
        "photo_sky_mask.png": 10401495,
    },
    "sky_classical_count": 5514139,
    "fcn_sha256": "6dac87d703721580f6acdb5653f7db330af5a23141eea47f43466e67e9361d62",
    "fcn_tiles": {
        "tiles": [[512, 512], [312, 416]],
        "jax_label_counts": [
            [28, 0, 0, 34, 0, 0, 25, 0, 254431, 0, 4031, 0, 0, 0, 0, 3434, 99, 0, 40, 22, 0],
            [0, 0, 0, 50, 0, 0, 30, 0, 122906, 0, 4265, 0, 76, 0, 0, 2339, 82, 0, 44, 0, 0],
        ],
        "port_cpu_label_counts": [
            [28, 0, 0, 34, 0, 0, 25, 0, 254431, 0, 4031, 0, 0, 0, 0, 3434, 99, 0, 40, 22, 0],
            [0, 0, 0, 50, 0, 0, 30, 0, 122906, 0, 4265, 0, 76, 0, 0, 2339, 82, 0, 44, 0, 0],
        ],
        "port_cpu_label_agreement": [1.0, 1.0],
        "port_cpu_max_abs_logit_diff": 1.2218952178955078e-06,
        "logit_scale": 0.7761886715888977,
    },
    "harmonize": {"max_gain_rel_err": 0.009524602630338386, "max_offset_err": 0.004214075956909556,
                  "unharmonized_max_gain_rel_err": 0.19992040871915417},
    "lidar": {"merged": {"points": 1572864, "scans": 3}, "decimated": {"points": 233368},
              "mesh": {"vertices": 38685, "faces": 106489}, "mesh_median_box_distance": 0.0009357523302382376,
              "mesh_p90_box_distance": 0.0017201660652538919},
}
# Gates: a reading may be this much worse than the JAX package's
AUX_GATES = dict(gain_factor=2.0, gain_slack=0.005, offset_slack=0.005, mesh_factor=1.25, mesh_slack_m=0.002,
                 label_count_factor=3.0, label_count_slack_px=16, decimated=(150_000, 400_000))


def aux_gates(ref=None, g=AUX_GATES) -> dict:
    """Each gate of the phase with the JAX reading it comes from."""
    ref = AUX_REFERENCE if ref is None else ref
    h = ref["harmonize"]
    tiles = ref["fcn_tiles"]
    # the port's CPU labels against JAX's on the same tiles, per class
    spread = max(abs(a - b) for p, j in zip(tiles["port_cpu_label_counts"], tiles["jax_label_counts"])
                 for a, b in zip(p, j))
    return {
        "mask_counts": ref["mask_counts"],
        "sky_classical_count": ref["sky_classical_count"],
        "fcn_sha256": ref["fcn_sha256"],
        "fcn_label_count_max_diff": {"max": int(g["label_count_factor"] * spread + g["label_count_slack_px"]),
                                     "jax": tiles["jax_label_counts"], "port_cpu_against_jax": spread},
        "fcn_label_agreement_min": {"min": min(tiles["port_cpu_label_agreement"]) - 0.01,
                                    "port_cpu_against_jax": tiles["port_cpu_label_agreement"]},
        "fcn_logit_rel_diff_max": AUX_FCN_LOGIT_TOL,
        "harmonize_max_gain_rel_err": max(g["gain_factor"] * h["max_gain_rel_err"], h["max_gain_rel_err"] + g["gain_slack"]),
        "harmonize_max_offset_err": max(g["gain_factor"] * h["max_offset_err"], h["max_offset_err"] + g["offset_slack"]),
        "harmonize_jax": h,
        "lidar_merged_points": ref["lidar"]["merged"],
        "lidar_decimated_points": ref["lidar"]["decimated"],
        "lidar_decimated_range": g["decimated"],
        "lidar_mesh_median_box_distance_max": g["mesh_factor"] * ref["lidar"]["mesh_median_box_distance"]
        + g["mesh_slack_m"],
        "lidar_jax": ref["lidar"],
    }


def aux_misses(row: dict, ref=None, g=AUX_GATES) -> list:
    """The phase's gates against its row."""
    gates, bad = aux_gates(ref, g), []
    m = row["masks"]
    if m["card_cpu_differ"]:
        bad.append(f"imageMasking: the card's masks differ from the CPU's: {m['card_cpu_differ']}")
    if m["counts"] != gates["mask_counts"]:
        diff = {k: (v, gates["mask_counts"].get(k)) for k, v in m["counts"].items() if gates["mask_counts"].get(k) != v}
        bad.append(f"imageMasking: foreground counts differ from the JAX package's (card, JAX): {diff}")
    s = row["segmentation"]
    if s["sky_classical_count"] != gates["sky_classical_count"]:
        bad.append(f"imageSegmentation: the sky scorer's mask holds {s['sky_classical_count']} pixels, the JAX "
                   f"package's {gates['sky_classical_count']}")
    f = s["fcn"]
    t = f["tiles"]
    if f["sha256"] != gates["fcn_sha256"]:
        bad.append(f"FCN: the .onnx file's sha256 {f['sha256']} is not the reference's {gates['fcn_sha256']}")
    if not f["mask_is_class0"]:
        bad.append("FCN: imageSegmentation's mask is not the pixels labelled class 0")
    if not t["max_rel_logit_diff"] <= gates["fcn_logit_rel_diff_max"]:
        bad.append(f"FCN tiles: the card's logits are {t['max_abs_logit_diff']} from the CPU's at a logit scale of "
                   f"{t['logit_scale']}, expected <= {gates['fcn_logit_rel_diff_max']} of it")
    if not min(t["label_agreement"]) >= gates["fcn_label_agreement_min"]["min"]:
        bad.append(f"FCN tiles: the card's labels agree with the CPU's on {t['label_agreement']}, expected >= "
                   f"{gates['fcn_label_agreement_min']}")
    lc = gates["fcn_label_count_max_diff"]
    worst = max(abs(a - b) for c, j in zip(t["card_label_counts"], lc["jax"]) for a, b in zip(c, j))
    if not worst <= lc["max"]:
        bad.append(f"FCN tiles: a class's label count is {worst} pixels from the JAX package's, expected <= "
                   f"{lc['max']} (port CPU against JAX: {lc['port_cpu_against_jax']})")
    h = row["harmonize"]["card"]
    if not (h["max_gain_rel_err"] <= gates["harmonize_max_gain_rel_err"]
            and h["max_offset_err"] <= gates["harmonize_max_offset_err"]):
        bad.append(f"sfmColorHarmonize: gains {h['max_gain_rel_err']} and offsets {h['max_offset_err']} off after "
                   f"harmonizing, expected <= {gates['harmonize_max_gain_rel_err']} and "
                   f"{gates['harmonize_max_offset_err']} (JAX {gates['harmonize_jax']})")
    li = row["lidar"]
    if li["card_cpu_differ"] or li["printed_differ"]:
        bad.append(f"lidar: the card's outputs differ from the CPU's: {li['card_cpu_differ'] + li['printed_differ']}")
    lo, hi = gates["lidar_decimated_range"]
    if li["merged"] != gates["lidar_merged_points"] or li["decimated"] != gates["lidar_decimated_points"] \
            or not lo <= li["decimated"]["points"] <= hi:
        bad.append(f"lidar: merged {li['merged']} and decimated {li['decimated']}, expected the JAX package's "
                   f"{gates['lidar_merged_points']} and {gates['lidar_decimated_points']} in {lo}..{hi}")
    if not li["mesh_median_box_distance"] <= gates["lidar_mesh_median_box_distance_max"]:
        bad.append(f"lidar: the mesh's median distance to the box world is {li['mesh_median_box_distance']}, "
                   f"expected <= {gates['lidar_mesh_median_box_distance_max']} (JAX {gates['lidar_jax']})")
    if any(row["sgm_launches"].values()):
        bad.append(f"the aux path launched SGM kernels: {row['sgm_launches']}")
    return bad


def check_aux(dev, work: str, smi: str) -> tuple:
    """The aux phase on the dense phase's views and the cli phase's outputs,
    and its gates. Returns (the row, its SGM launches, all 0)."""
    row = run_aux_phase(dev, work, os.path.join(work, "cli"), os.path.join(work, "images"), smi=smi)
    row["gates"] = aux_gates()
    bad = aux_misses(row)
    if bad:
        raise RuntimeError("aux: " + "; ".join(bad))
    return row, row["sgm_launches"]


# ------------------------------------------------------------ scaleout

# Checks of the scaleout phase. One card holds one rank (nccl puts no two
# ranks on one device), so the phase joins an nccl group of one through
# the port's own join (distributed.join_group), runs the port's counted
# all_reduce, all_gather and gather over it on card tensors (each returns
# its input and tallies its bytes), then the sharded programs: every
# collective of a one-rank mesh is skipped, as the JAX package's one-shard
# programs hold none, so their reduce paths and the ring exchange run on
# gloo ranks in the CPU tests only, and no scaling is measured. The
# sharded BA is held to ba_solve on the same card at tests/
# test_sharded_ba.py's tolerances (the card's index_add_ sums vary from run
# to run); the sharded SGM maps and the ring-halo filter are held equal.
SCALEOUT_BA = dict(cost_initial_rtol=1e-4, cost_final_rtol=1e-3, cost_final_atol=1e-4, cam_c_atol=5e-3)
SCALEOUT_D = 96
SCALEOUT_RING_K = 4


def check_scaleout(dev, work: str, sfm: str, dense: str, smi: str) -> tuple:
    """The scaleout phase on the dense phase's scene: nccl on a card (gloo
    and no kernel launch on the CPU, where the port's tests run it small).
    Returns (the row, its SGM launches)."""
    import torch.distributed as dist

    from alicevision_tpu_torch.mvs.fusion import consistency_filter_ring
    from alicevision_tpu_torch.mvs.sharded import (batched_sgm, gather_to_primary, make_sharded_consistency_filter,
                                                   make_sharded_sgm)
    from alicevision_tpu_torch.parallel import comms_report, distributed, make_mesh, solve_sharded

    t_phase = time.perf_counter()
    row, bad, total = {"card": smi, "seconds": {}}, [], dict.fromkeys(sgm_kernel.launches, 0)
    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    distributed.join_group(dev, "127.0.0.1", distributed.free_port(), 1, 0)
    try:
        mesh = make_mesh()
        row["backend"], row["world_size"], row["mesh"] = dist.get_backend(), dist.get_world_size(), mesh.shape

        # the port's counted collectives over the group of one, on `dev`
        x = torch.arange(1024, dtype=torch.float32, device=dev)
        distributed.reset_comm_bytes()
        outs = {"all-reduce": distributed.all_reduce(x.clone()), "all-gather": distributed.all_gather(x)[0],
                "gather": distributed.gather_to_primary(x)}
        row["collectives"] = {"equal": {k: bool(torch.equal(v, x)) for k, v in outs.items()},
                              "bytes": dict(distributed.comm_bytes),
                              "device": str(torch.cuda.current_device()) if cuda else "cpu"}
        if not all(row["collectives"]["equal"].values()) or row["collectives"]["bytes"] != dict.fromkeys(
                outs, x.numel() * 4):
            bad.append(f"collectives over the group of one: {row['collectives']}")

        def sync():
            if cuda:
                torch.cuda.synchronize()

        def timed(name, fn):
            sync()
            sgm_kernel.launches.update(dict.fromkeys(sgm_kernel.launches, 0))
            t0 = time.perf_counter()
            out = fn()
            sync()
            row["seconds"][name] = time.perf_counter() - t0
            got = dict(sgm_kernel.launches)
            for k in total:
                total[k] += got[k]
            return out, got

        # the landmark-sharded BA against ba_solve on the card
        mid = make_mid_problem(dev)
        row["ba"] = []
        for solver in ("dense", "pcg"):
            distributed.reset_comm_bytes()
            sh, _ = timed(f"solve_sharded_{solver}", lambda: solve_sharded(mid, mesh, max_iters=25, solver=solver))
            coll = dict(distributed.comm_bytes)
            one, _ = timed(f"ba_solve_{solver}", lambda: ba.ba_solve(mid, max_iters=25, solver=solver))
            r = {"solver": solver, "cost_initial": float(sh.cost_initial), "cost_final": float(sh.cost_final),
                 "ba_solve_cost_initial": float(one.cost_initial), "ba_solve_cost_final": float(one.cost_final),
                 "n_iters": int(sh.n_iters), "ba_solve_n_iters": int(one.n_iters),
                 "max_cam_c_diff": float((sh.cam_c - one.cam_c).abs().max()), "collective_bytes": coll}
            row["ba"].append(r)
            tol = SCALEOUT_BA
            if not (math.isclose(r["cost_initial"], r["ba_solve_cost_initial"], rel_tol=tol["cost_initial_rtol"])
                    and abs(r["cost_final"] - r["ba_solve_cost_final"])
                    <= tol["cost_final_atol"] + tol["cost_final_rtol"] * abs(r["ba_solve_cost_final"])
                    and r["max_cam_c_diff"] < tol["cam_c_atol"] and not coll):
                bad.append(f"sharded BA ({solver}) against ba_solve: {r}")

        # view-sharded SGM on the dense scene's views at D = 96
        sc = sfmdata.load(sfm)
        views = list(sc.valid_views())
        inputs = [_view_inputs(sfm, dense, v, SCALEOUT_D, dev) for v in views]
        names = ("ref_imgs", "t_imgs", "K_ref", "K_t", "R_rel", "t_rel")
        batch = {n: torch.stack([args[i] for args, _ in inputs]) for i, n in enumerate(names)}
        batch["depths"] = torch.stack([torch.as_tensor(kw["depths"], dtype=torch.float32, device=dev)
                                       for _, kw in inputs])
        batch["tc_depth_ranges"] = torch.stack([kw["tc_depth_ranges"] for _, kw in inputs])
        params = plane_sweep.SgmParams(n_depths=SCALEOUT_D)
        sgm = make_sharded_sgm(mesh, params, device=dev)
        (d_sh, _), got_sh = timed("make_sharded_sgm", lambda: sgm(**batch))
        (d_one, _), got_one = timed("batched_sgm", lambda: batched_sgm(*(batch[n] for n in names), batch["depths"],
                                                                       params, batch["tc_depth_ranges"]))
        maps = gather_to_primary(d_sh, mesh)
        want = {"sgm_directional_pass": 0, "sgm_axis_sweeps": LAUNCHES_PER_MAP * len(views) if cuda else 0}
        row["sgm"] = {"views": len(views), "n_depths": SCALEOUT_D, "launches": got_sh,
                      "batched_sgm_launches": got_one, "equal_to_batched_sgm": bool(torch.equal(maps, d_one)),
                      "max_abs_diff": float((maps - d_one).abs().max()),
                      "finite": bool(torch.isfinite(maps).all())}
        if got_sh != want or got_one != want:
            bad.append(f"sharded SGM: launches {got_sh} (batched_sgm {got_one}), expected {want}")
        if not (row["sgm"]["equal_to_batched_sgm"] and row["sgm"]["finite"]):
            bad.append(f"sharded SGM maps differ from batched_sgm's: {row['sgm']}")

        # the ring-halo consistency filter on those maps
        K = torch.stack([inputs[i][0][2] for i in range(len(views))])
        R = torch.as_tensor(np.stack([sc.pose_R[int(sc.view_pose[v])] for v in views]), dtype=torch.float32,
                            device=dev)
        c = torch.as_tensor(np.stack([sc.pose_c[int(sc.view_pose[v])] for v in views]), dtype=torch.float32,
                            device=dev)
        fuse = make_sharded_consistency_filter(mesh, k=SCALEOUT_RING_K, device=dev)
        (f_sh, n_sh), _ = timed("sharded_consistency_filter", lambda: fuse(maps, K, R, c))
        (f_one, n_one), _ = timed("consistency_filter_ring",
                                  lambda: consistency_filter_ring(maps, K, R, c, k=SCALEOUT_RING_K))
        row["fusion"] = {"k": SCALEOUT_RING_K, "filtered_equal": bool(torch.equal(f_sh, f_one)),
                         "counts_equal": bool(torch.equal(n_sh, n_one)),
                         "kept_frac": float((f_sh > 0).float().mean())}
        if not (row["fusion"]["filtered_equal"] and row["fusion"]["counts_equal"]):
            bad.append(f"ring-halo filter differs from consistency_filter_ring: {row['fusion']}")

        # the comms tables at one shard, in this process on the card
        (ba_rows, fusion_rows), _ = timed("comms_tables", lambda: (
            comms_report.ba_comms_table(shard_counts=(1,), device=dev),
            comms_report.fusion_comms_table(shard_counts=(1,), device=dev)))
        row["comms"] = {"ba": ba_rows, "fusion": fusion_rows}
        if any(r["collective_bytes"] != 0 for r in ba_rows + fusion_rows) or len(ba_rows + fusion_rows) != 2:
            bad.append(f"comms tables at one shard: {row['comms']}")
    finally:
        dist.destroy_process_group()
    row["sgm_launches"] = total
    row["phase_seconds"] = time.perf_counter() - t_phase
    print("scaleout " + json.dumps(row), flush=True)
    if bad:
        raise RuntimeError("scaleout: " + "; ".join(bad))
    return row, total


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


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="The port's smoke run on one CUDA card (no arguments needed).")
    ap.add_argument("--keep-localization", default=None, metavar="DIR",
                    help="save the localization phase's reconstruction and the features it names to DIR "
                         "(scripts/localization_reference.py --inputs DIR reads it)")
    keep_localization = ap.parse_args(argv).keep_localization
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device (torch.cuda.is_available() is False)")
    t_start = time.perf_counter()
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
    t0 = time.perf_counter()
    print(f"build native/maxflow.cpp (g++, the graph cut's max-flow): {native.build().name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    print(f"build native/jpeg.cpp (g++, the JPEG codec): {native.build(native.JPEG_SRC).name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    print(f"build native/codecs.cpp (g++, the TIFF and PNG loops): {native.build(native.CODECS_SRC).name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

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

        # 4b. the graph-cut surface mesher on the D = 96 maps
        mesh_surface = check_mesh_surface(dev, work, sfm, depth96)

        # 5. the rest of the dense stages: Refine, normals, tiles, guided
        # filtering, and bench.py's dense points
        dense_full, full_launches = check_dense_full(dev, work, sfm, gt, res["dense"], depth96, n_views, smi)

        # 6. the SfM front end on the same images
        front = check_front(dev, work, os.path.join(work, "images"), sfm, n_views)

        # 7. the whole main path, images to cloud.ply, on the same images
        pipe, pipe_launches = check_pipeline(dev, work, os.path.join(work, "images"), sfm, gt)

        # 7a. photographs: the port's JPEG codec and EXIF reader, the
        # pipeline from camera JPEGs, the JAX photo test's operating point
        photos_row, photos_launches = check_photos(dev, work, os.path.join(work, "images"), sfm, gt,
                                                   pipe["stage_seconds_warm"], smi)

        # 7a'. TIFF, BMP, PNG and MJPEG AVI through the port's own readers,
        # the pipeline from camera TIFFs, keyframeSelection from an AVI
        codecs_row, codecs_launches = check_codecs(dev, work, os.path.join(work, "images"), sfm, gt, smi)

        # 7b. Meshroom's chain through the CLI, one process a stage
        cli_row, cli_launches = check_cli(dev, work, os.path.join(work, "images"), sfm, gt, smi)

        # 7c. the HDR panorama chain, and global SfM on the cli phase's features
        pano_row, pano_launches = check_panorama(dev, work, os.path.join(work, "cli"), sfm, smi)

        # 8. the hard scene: the engine on 40 distorted views, and the images
        # path at the reference's operating point
        hard = check_hard_scene(dev, work, smi)

        # 8b. camera and rig localization, the remaining resection solvers and
        # the scene tools on the hard scene's reconstruction
        loc_row, loc_launches = check_localization(dev, work, smi, keep_localization)

        # 8c. the main path's float32 null-vector solvers, card against CPU
        solvers = check_solvers_on_card(dev)

        # 8d. calibration, distortion, the colour chart and photometric stereo
        cal_row, cal_launches = check_calibration(dev, work, smi)

        # 8e. the front-end extras and item 13 (a)'s subcommands on the cli
        # phase's outputs
        extras_row, extras_launches = check_extras(dev, work, smi)

        # 8f. item 13 (d)'s subcommands: masking, segmentation through the
        # ONNX executor, colour harmonization and the lidar chain
        aux_row, aux_launches = check_aux(dev, work, smi)

        # 8g. scale-out over an nccl group of one rank: the sharded BA,
        # view-sharded SGM, the ring-halo filter and the comms tables
        scale_row, scale_launches = check_scaleout(dev, work, sfm, res["dense"], smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 9. the bundle adjuster
    ba_rows = check_ba(dev)

    # 10. results
    print(json.dumps({"mesh_surface": mesh_surface}), flush=True)
    print(json.dumps({"hard_scene": hard}), flush=True)
    print(json.dumps({"dense_full": dense_full}), flush=True)
    print(json.dumps({"front": front}), flush=True)
    print(json.dumps({"pipeline": pipe}), flush=True)
    print(json.dumps({"photos": photos_row}), flush=True)
    print(json.dumps({"codecs": codecs_row}), flush=True)
    print(json.dumps({"ba": ba_rows}), flush=True)
    print(json.dumps({"cli": cli_row}), flush=True)
    print(json.dumps({"panorama": pano_row}), flush=True)
    print(json.dumps({"localization": loc_row}), flush=True)
    print(json.dumps({"solvers": solvers}), flush=True)
    print(json.dumps({"calibration": cal_row}), flush=True)
    print(json.dumps({"extras": extras_row}), flush=True)
    print(json.dumps({"aux": aux_row}), flush=True)
    print(json.dumps({"scaleout": scale_row}), flush=True)
    launches = {k: launches[k] + pipe_launches[k] + photos_launches[k] + codecs_launches[k] + full_launches[k]
                + cli_launches[k]
                + pano_launches[k]
                + loc_launches[k] + cal_launches[k] + extras_launches[k] + aux_launches[k] + scale_launches[k]
                for k in launches}
    print(json.dumps({"kernels": [kernels_line(rows, agg_rows, launches)]}), flush=True)
    print(f"smoke seconds: {time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
