"""The port's incremental SfM engine (`sfm/incremental.py`) against the JAX
reference on the CPU.

The scene is the JAX package's synthetic ring (`ring_scene(8, 120, 0.3,
seed=0)`, the fixture of tests/test_incremental_sfm.py), carried over as
numpy, with perfect tracks of every point seen by 3 views or more. Both
engines run with the same configuration (64 RANSAC hypotheses and 3
initial-pair candidates, to keep the CPU run short); their random streams
differ, so whole runs are compared by their results: all 8 views posed,
ATE < 0.05 (radius 5) and rotations < 1 deg after a similarity alignment,
and the two engines' aligned centres within 5e-3 of each other.

Single steps are compared from one state: a JAX engine is advanced to
three posed views, its host state is carried into a port engine
(`convert.carry_engine_state`), and both take the same step.
`candidate_pairs`, `view_scores` and `remove_outliers` are host numpy in
both and must agree exactly; `triangulate_all` (float32 eigh in each
library) gives the same validity and points within 1e-4; one
`bundle_adjust` gives poses and points within rtol 1e-3 (atol 1e-4).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from alicevision_tpu import camera as jcam
from alicevision_tpu import sfmdata as jsfm
from alicevision_tpu.sfm.incremental import IncrementalConfig as JConfig
from alicevision_tpu.sfm.incremental import IncrementalSfM as JEngine
from alicevision_tpu.tracks.builder import Tracks as JTracks
from alicevision_tpu.utils.synthetic import ring_scene
from alicevision_tpu_torch import convert, sfmdata
from alicevision_tpu_torch.sfm.incremental import IncrementalSfM

torch.set_num_threads(1)

CFG = dict(seed=0, n_ransac_hyps=64, init_pair_candidates=3)
N_VIEWS = 8
SIZES = np.tile([1920, 1080], (N_VIEWS, 1))


def _align_similarity(a, b):
    """Similarity (s, R, t) aligning point sets a -> b (Umeyama)."""
    mu_a, mu_b = a.mean(0), b.mean(0)
    ac, bc = a - mu_a, b - mu_b
    U, S, Vt = np.linalg.svd(bc.T @ ac / len(a))
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / ((ac**2).sum() / len(a))
    return s, R, mu_b - s * R @ mu_a


@pytest.fixture(scope="module")
def ring():
    """The ring scene as numpy: perfect tracks (points seen by >= 3 views),
    per-view feature tables, the intrinsics row, true poses."""
    scene = ring_scene(n_views=N_VIEWS, n_points=120, noise_px=0.3, seed=0)
    vis = np.asarray(scene.visible)
    obs = np.asarray(scene.observations)
    t_ids, t_views, t_feats = [], [], []
    feats = {v: [] for v in range(N_VIEWS)}
    n_track = 0
    for p in range(vis.shape[1]):
        views = np.nonzero(vis[:, p])[0]
        if len(views) < 3:
            continue
        for v in views:
            t_ids.append(n_track)
            t_views.append(v)
            t_feats.append(len(feats[v]))
            feats[v].append(obs[v, p])
        n_track += 1
    tracks = (np.array(t_ids, np.int32), np.array(t_views, np.int32), np.array(t_feats, np.int32), n_track)
    fxy = {v: np.array(f) for v, f in feats.items()}
    intr = [np.asarray(a)[None] for a in scene.intrinsics]
    return dict(tracks=tracks, fxy=fxy, intr=intr, R=np.asarray(scene.poses.R), c=np.asarray(scene.poses.c))


def _jax_engine(ring):
    return JEngine(JTracks(*ring["tracks"]), ring["fxy"], jcam.Intrinsics(*ring["intr"]),
                   np.zeros(N_VIEWS, np.int32), SIZES, JConfig(**CFG))


def _port_engine(ring):
    cfg = convert.incremental_config_from_reference(dataclasses.asdict(JConfig(**CFG)))
    return IncrementalSfM(convert.tracks_from_numpy(*ring["tracks"]), ring["fxy"], ring["intr"],
                          np.zeros(N_VIEWS, np.int32), SIZES, cfg, device="cpu")


def _aligned(res, ring):
    est = res.pose_c[res.posed]
    s, R, t = _align_similarity(est, ring["c"][res.posed])
    return est @ (s * R).T + t, R


@pytest.fixture(scope="module")
def runs(ring):
    jax_eng = _jax_engine(ring)
    jax_eng.process()
    port_eng = _port_engine(ring)
    port_eng.process()
    return jax_eng, port_eng


def test_ring_reconstruction(ring, runs):
    jax_eng, port_eng = runs
    res = port_eng.res
    assert res.posed.sum() == N_VIEWS, res.posed
    assert res.point_valid.sum() > 80
    aligned, R = _aligned(res, ring)
    ate = np.sqrt(np.mean(np.sum((aligned - ring["c"]) ** 2, axis=1)))
    assert ate < 0.05, ate
    for v in range(N_VIEWS):
        Ra = res.pose_R[v] @ R.T
        ang = np.degrees(np.arccos(np.clip((np.trace(Ra @ ring["R"][v].T) - 1) / 2, -1, 1)))
        assert ang < 1.0, (v, ang)
    assert jax_eng.res.posed.sum() == N_VIEWS
    aligned_j, _ = _aligned(jax_eng.res, ring)
    np.testing.assert_allclose(aligned, aligned_j, atol=5e-3)
    # the same kinds of steps, and a BA after every group
    kinds = [h[0] for h in res.history]
    assert kinds[0] == "init" and kinds.count("ba") >= 3 and "refine_intrinsics" in kinds
    assert set(port_eng.seconds) >= {"initial_pair", "resection", "triangulation", "ba", "joint_ba"}


@pytest.fixture(scope="module")
def mid_state(ring):
    """A JAX engine after its initial pair, first BA, outlier removal and
    one resected view (three posed)."""
    eng = _jax_engine(ring)
    assert eng.initialize()
    eng.triangulate_all()
    eng.bundle_adjust()
    eng.remove_outliers()
    eng.triangulate_all()
    scores = eng.view_scores()
    assert eng.resect_views([int(np.argmax(scores))])
    return eng


def _carried(ring, mid_state):
    return copy.deepcopy(mid_state), convert.carry_engine_state(mid_state, _port_engine(ring))


def test_candidate_pairs(ring):
    assert _port_engine(ring).candidate_pairs(top=20) == _jax_engine(ring).candidate_pairs(top=20)


def test_view_scores_and_counts(ring, mid_state):
    j, t = _carried(ring, mid_state)
    np.testing.assert_array_equal(t.view_scores(), j.view_scores())
    np.testing.assert_array_equal(t.view_usable_counts(), j.view_usable_counts())


def test_triangulate_all(ring, mid_state):
    j, t = _carried(ring, mid_state)
    j.triangulate_all()
    t.triangulate_all()
    np.testing.assert_array_equal(t.res.point_valid, j.res.point_valid)
    ok = j.res.point_valid
    assert ok.sum() > 50
    np.testing.assert_allclose(t.res.points[ok], j.res.points[ok], rtol=1e-4, atol=1e-4)


def test_remove_outliers(ring, mid_state):
    j, t = _carried(ring, mid_state)
    # a few corrupted points, so that observations get flagged
    for e in (j, t):
        e.res.points[np.nonzero(e.res.point_valid)[0][:5]] += 0.5
    assert t.remove_outliers() == j.remove_outliers() > 0
    np.testing.assert_array_equal(t.obs_inlier, j.obs_inlier)
    np.testing.assert_array_equal(t.res.point_valid, j.res.point_valid)
    np.testing.assert_array_equal(t._last_outlier_tracks, j._last_outlier_tracks)


def test_bundle_adjust(ring, mid_state):
    j, t = _carried(ring, mid_state)
    j.bundle_adjust()
    t.bundle_adjust()
    np.testing.assert_allclose(t.res.pose_R, j.res.pose_R, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(t.res.pose_c, j.res.pose_c, rtol=1e-3, atol=1e-4)
    ok = j.res.point_valid
    np.testing.assert_allclose(t.res.points[ok], j.res.points[ok], rtol=1e-3, atol=1e-4)
    (_, c0_t, c1_t, _), (_, c0_j, c1_j, _) = t.res.history[-1], j.res.history[-1]
    np.testing.assert_allclose([c0_t, c1_t], [c0_j, c1_j], rtol=1e-3)


def test_export_reload_and_seed(ring, runs, tmp_path):
    """to_sfmdata -> save -> load (the port's and the JAX package's
    loaders), then a fresh engine seeded from the reloaded scene."""
    _, port_eng = runs
    sc = port_eng.to_sfmdata()
    assert sc.n_poses == N_VIEWS and sc.n_landmarks == int(port_eng.res.point_valid.sum())
    path = str(tmp_path / "out.sfm")
    sfmdata.save(sc, path)
    for loaded in (sfmdata.load(path), jsfm.load(path)):
        assert loaded.n_poses == sc.n_poses and loaded.n_landmarks == sc.n_landmarks
        np.testing.assert_array_equal(np.asarray(loaded.landmark_ids), np.nonzero(port_eng.res.point_valid)[0])
        np.testing.assert_allclose(np.asarray(loaded.points), sc.points, rtol=1e-6, atol=1e-9)
    seeded = _port_engine(ring)
    seeded.seed_from_sfmdata(sfmdata.load(path))
    assert seeded.res.posed.all()
    np.testing.assert_array_equal(seeded.res.point_valid, port_eng.res.point_valid)
    np.testing.assert_allclose(seeded.res.pose_c, port_eng.res.pose_c, atol=1e-9)
