"""The port's `pipeline/runner.py::run_full_pipeline` end to end on the CPU,
and the `.sfm` contract with the JAX package.

A rendered 4-view 640x480 scene (`chip_smoke.make_posed_scene`: `.npy`
images, focal 560 px, a 0.6 rad arc) goes through every stage of the
port's main path with `device="cpu"`, at a CPU-sized operating point: 1024
keypoints, 16 SGM planes, and an incremental engine of 64 RANSAC
hypotheses and 3 initial-pair candidates. `chip_smoke.pipeline_report`
(the card's check, run here on the CPU) holds the poses to the rendered
ones after a similarity alignment: every view posed, camera-centre ATE
below 1 % of the ring radius, rotations within 1 deg. The JAX package's
`sfmdata.load` reads the port's sfm.sfm, and the port reads the file the
JAX package writes back.
"""

import json
import os

import chip_smoke
import numpy as np
import pytest
import torch

from alicevision_tpu import sfmdata as jsfm
from alicevision_tpu_torch import sfmdata
from alicevision_tpu_torch.pipeline import stages
from alicevision_tpu_torch.pipeline.runner import run_full_pipeline
from alicevision_tpu_torch.sfm.incremental import IncrementalConfig, IncrementalSfM
from alicevision_tpu_torch.tracks import Tracks

torch.set_num_threads(1)

N_VIEWS, WH, FOCAL = 4, (640, 480), 560.0


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipeline"))
    posed_sfm, gt = chip_smoke.make_posed_scene(root, n_views=N_VIEWS, wh=WH, focal_px=FOCAL, n_points=500)
    work = os.path.join(root, "work")
    seconds, launches = chip_smoke.run_pipeline(
        work, os.path.join(root, "images"), "cpu", focal_px=FOCAL, max_keypoints=1024, n_depths=16,
        sfm_config=IncrementalConfig(n_ransac_hyps=64, init_pair_candidates=3),
    )
    truth = sfmdata.load(posed_sfm)
    report = chip_smoke.pipeline_report(work, truth.pose_R[truth.view_pose], truth.pose_c[truth.view_pose], gt)
    return dict(work=work, seconds=seconds, launches=launches, report=report, root=root)


def test_run_full_pipeline_poses(run):
    rep = run["report"]
    assert rep["n_posed"] == N_VIEWS, rep
    assert rep["ate_frac_of_radius"] < 0.01, rep
    assert max(rep["rotation_err_deg"]) < 1.0, rep
    assert rep["landmarks"] >= 50 and rep["cloud_points"] > 0, rep
    # every stage ran, and the CPU path launched no kernel
    with open(os.path.join(run["work"], "timings.json")) as f:
        assert list(json.load(f)) == list(run["seconds"]) == [
            "cameraInit", "featureExtraction", "imageMatching", "featureMatching", "incrementalSfm",
            "prepareDenseScene", "depthMapEstimation", "depthMapFiltering", "meshing"]
    assert not any(run["launches"].values())
    kinds = [h[0] for h in stages.last_engine.res.history]
    assert kinds[0] == "init" and "ba" in kinds


def test_run_full_pipeline_resumes(run):
    """A second call over the same work folder finds every output and runs
    no stage."""
    seconds, _ = chip_smoke.run_pipeline(run["work"], os.path.join(run["root"], "images"), "cpu",
                                         focal_px=FOCAL, max_keypoints=1024, n_depths=16)
    assert set(seconds.values()) == {0.0}


def test_sfm_file_both_ways(run, tmp_path):
    path = os.path.join(run["work"], "sfm.sfm")
    sc_t = sfmdata.load(path)
    sc_j = jsfm.load(path)
    assert sc_j.n_views == sc_t.n_views == N_VIEWS
    assert sc_j.n_landmarks == sc_t.n_landmarks == run["report"]["landmarks"]
    np.testing.assert_allclose(np.asarray(sc_j.pose_c), sc_t.pose_c, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(sc_j.scale), sc_t.scale, rtol=1e-9)
    back = str(tmp_path / "from_jax.sfm")
    jsfm.save(sc_j, back)
    sc_b = sfmdata.load(back)
    np.testing.assert_array_equal(sc_b.landmark_ids, sc_t.landmark_ids)
    np.testing.assert_allclose(sc_b.points, sc_t.points, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(sc_b.pose_R, sc_t.pose_R, rtol=1e-9, atol=1e-12)
    assert list(sc_b.view_paths) == list(sc_t.view_paths)


def test_stages_need_cuda_by_default(run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    w = run["work"]
    with pytest.raises(RuntimeError, match="CUDA"):
        stages.incremental_sfm(os.path.join(w, "cameraInit.sfm"), os.path.join(w, "features"),
                               os.path.join(w, "matches.npz"), os.path.join(w, "again.sfm"))
    with pytest.raises(RuntimeError, match="CUDA"):
        stages.tracks_building(os.path.join(w, "cameraInit.sfm"), os.path.join(w, "features"),
                               os.path.join(w, "matches.npz"), os.path.join(w, "tracks.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_full_pipeline(os.path.join(run["root"], "images"), os.path.join(run["root"], "again"))
    sc = sfmdata.load(os.path.join(w, "cameraInit.sfm"))
    with pytest.raises(RuntimeError, match="CUDA"):
        IncrementalSfM(Tracks(*(np.zeros(0, np.int32),) * 3, 0), {}, sc.intrinsics_table(),
                       sc.view_intrinsic, sc.view_sizes)
    for fn in (stages.sfm_bootstrapping, stages.sfm_expanding):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(os.path.join(w, "cameraInit.sfm"), os.path.join(w, "features"), "tracks.npz", "out.sfm")
