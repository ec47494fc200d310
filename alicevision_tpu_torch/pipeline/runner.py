"""Full-pipeline runner with stage-level checkpoints.

Port of `alicevision_tpu/pipeline/runner.py`: the canonical stage chain,
run in-process (the reference wires its per-stage binaries through files
with an external orchestrator, README.md:75-80). Stages whose outputs
already exist are skipped (file-granular resume), and each stage's wall
seconds go to `timings.json`. Every stage runs on `device`.
"""

from __future__ import annotations

import json
import os
import time

import torch

from ..device import resolve_device


def run_full_pipeline(
    image_folder: str,
    work_folder: str,
    method: str = "exhaustive",
    max_keypoints: int = 4096,
    skip_mvs: bool = False,
    default_focal_px: float | None = None,
    n_depths: int = 96,
    sfm_config=None,
    device="cuda",
) -> dict:
    """Images -> cameraInit.sfm, features/, pairs.txt, matches.npz, sfm.sfm,
    then (unless skip_mvs) dense/, depth/, depth_filtered/ and cloud.ply
    under `work_folder`. n_depths: SGM planes a map (the reference stage's
    default); sfm_config: an IncrementalConfig for incrementalSfm (its
    defaults otherwise). Returns the stage seconds (0.0 for a stage resumed
    from its files); on a CUDA device each stage's time ends in a
    synchronize."""
    from . import stages

    dev = resolve_device(device)
    os.makedirs(work_folder, exist_ok=True)
    p = lambda *x: os.path.join(work_folder, *x)  # noqa: E731
    timings = {}

    def stage(name, outputs, fn):
        if all(os.path.exists(o) for o in outputs):
            timings[name] = 0.0
            return
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings[name] = time.perf_counter() - t0

    scene = p("cameraInit.sfm")
    stage("cameraInit", [scene],
          lambda: stages.camera_init(image_folder, scene, default_focal_px=default_focal_px, device=dev))

    feats = p("features")
    stage("featureExtraction", [feats],
          lambda: stages.feature_extraction(scene, feats, max_keypoints=max_keypoints, device=dev))

    pairs = p("pairs.txt")
    stage("imageMatching", [pairs],
          lambda: stages.image_matching(scene, feats, pairs, method=method, device=dev))

    matches = p("matches.npz")
    stage("featureMatching", [matches],
          lambda: stages.feature_matching(scene, feats, pairs, matches, device=dev))

    sfm_out = p("sfm.sfm")
    stage("incrementalSfm", [sfm_out],
          lambda: stages.incremental_sfm(scene, feats, matches, sfm_out, config=sfm_config, device=dev))

    if not skip_mvs:
        dense = p("dense")
        stage("prepareDenseScene", [dense],
              lambda: stages.prepare_dense_scene(sfm_out, dense, device=dev))

        depth = p("depth")
        stage("depthMapEstimation", [depth],
              lambda: stages.depth_map_estimation(sfm_out, dense, depth, n_depths=n_depths, device=dev))

        depthf = p("depth_filtered")
        stage("depthMapFiltering", [depthf],
              lambda: stages.depth_map_filtering(sfm_out, depth, depthf, device=dev))

        cloud = p("cloud.ply")
        stage("meshing", [cloud],
              lambda: stages.meshing_point_cloud(sfm_out, depthf, cloud, device=dev))

    with open(p("timings.json"), "w") as f:
        json.dump(timings, f, indent=1)
    return timings
