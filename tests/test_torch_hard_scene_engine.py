"""The port's SfM engine on the hard scene (tests/test_torch_hard_scene.py's
40-view ring, `_run_engine` and CPU configuration), held to
tests/test_hard_scene.py's gates on the CPU:

- the reference's normal prior (focal 2 % off, zero K3): >= 38 of 40
  posed, ATE < 1 % of the radius, k1 within 0.03, focal within 1 %,
  centres within 0.02 of tests/golden/hard_scene_poses.npz after
  alignment;
- its stressed prior (focal 10 % off, a (20, -12) px principal point):
  >= 36 posed, ATE < 1.5 %, focal within 2 %, k1 within 0.06, the
  principal point within 0.65 of the prior's offset.

A file of its own, apart from the scene's array and render checks, so
that the two long engine runs start early on their own test worker.
"""

import dataclasses

import numpy as np
import torch

from test_torch_hard_scene import GOLDEN, _align_similarity, _run_engine

torch.set_num_threads(1)


def test_hard_scene_engine_meets_gates_and_golden():
    hs, engine, res, posed, ate_rel = _run_engine(stressed=False)
    assert len(posed) >= 38, posed
    assert ate_rel < 0.01, ate_rel
    k1 = float(engine.intr_np.disto[0, 0])
    f = float(engine.intr_np.scale[0, 0])
    assert abs(k1 - hs.disto[0]) < 0.03, k1
    assert abs(f - hs.K[0, 0]) / hs.K[0, 0] < 0.01, f
    assert dataclasses.asdict(engine.cfg)["robust_triangulation"]

    g = np.load(GOLDEN)
    both = np.intersect1d(posed, g["posed"])
    assert len(both) >= 38
    s1, R1, t1 = _align_similarity(res.pose_c[both], hs.c[both])
    s2, R2, t2 = _align_similarity(g["pose_c"][both], hs.c[both])
    drift = np.linalg.norm((res.pose_c[both] @ (s1 * R1).T + t1) - (g["pose_c"][both] @ (s2 * R2).T + t2), axis=1)
    assert drift.max() < 0.02, drift.max()


def test_hard_scene_engine_stressed_prior():
    hs, engine, res, posed, ate_rel = _run_engine(stressed=True)
    assert len(posed) >= 36, posed
    assert ate_rel < 0.015, ate_rel
    f = float(engine.intr_np.scale[0, 0])
    k1 = float(engine.intr_np.disto[0, 0])
    pp = engine.intr_np.offset[0]
    assert abs(f - hs.K[0, 0]) / hs.K[0, 0] < 0.02, f
    assert abs(k1 - hs.disto[0]) < 0.06, k1
    assert np.linalg.norm(pp) < 0.65 * np.linalg.norm([20.0, -12.0]), pp
