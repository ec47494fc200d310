"""The port's and the JAX package's incremental SfM engines run whole on
tests/test_torch_incremental.py's ring (its fixture, configuration and
tolerances): all 8 views posed, ATE < 0.05 (radius 5) and rotations < 1
deg after a similarity alignment, the two engines' aligned centres within
5e-3 of each other; then the port's result exported, reloaded by both
packages' loaders and seeded into a fresh engine.

A file of its own, apart from the single-step checks, so that the two
engine runs start early on their own test worker.
"""

import numpy as np
import pytest
import torch

from alicevision_tpu import sfmdata as jsfm
from alicevision_tpu_torch import sfmdata
from test_torch_incremental import N_VIEWS, _aligned, _jax_engine, _port_engine, ring  # noqa: F401 (ring: a fixture)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(ring):  # noqa: F811
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
