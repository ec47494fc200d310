"""The port's modular SfM (`sfm/expansion.py` and the stages tracksBuilding
-> sfmBootstraping -> sfmExpanding) on the CPU.

The file-contract fixture of tests/test_modular_pipeline.py (the JAX
package's synthetic 6-view ring, noise 0.3 px, one feature a point) goes
through the port's three stages under that test's gates
(tests/test_torch_expansion_chain.py). The engines' random streams
differ, so whole runs are held to the gates, not to JAX's numbers. The policies are host numpy over the
engine's state: from a JAX engine bootstrapped with the same small
configuration and carried into a port engine (`convert.carry_engine_state`)
their choices are equal. The checkpoint round trip restores the state
exactly.
"""

import os

import numpy as np
import pytest
import torch

from alicevision_tpu import sfmdata as jsfm
from alicevision_tpu.sfm import expansion as jexp
from alicevision_tpu.sfm.incremental import IncrementalConfig as JConfig
from alicevision_tpu.sfm.incremental import IncrementalSfM as JEngine
from alicevision_tpu.tracks.builder import build_tracks as jbuild_tracks
from alicevision_tpu.utils.synthetic import ring_scene
from alicevision_tpu_torch import convert, sfmdata
from alicevision_tpu_torch.sfm import expansion as texp
from alicevision_tpu_torch.sfm.alignment import umeyama_similarity
from alicevision_tpu_torch.sfm.incremental import IncrementalConfig, IncrementalSfM
from alicevision_tpu_torch.tracks.builder import build_tracks

torch.set_num_threads(1)

N_VIEWS, N_POINTS = 6, 90
CFG = dict(seed=0, n_ransac_hyps=64, init_pair_candidates=3)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """tests/test_modular_pipeline.py's scene file, features and matches."""
    d = tmp_path_factory.mktemp("modular")
    syn = ring_scene(n_views=N_VIEWS, n_points=N_POINTS, noise_px=0.3, seed=4)
    vis, obs = np.asarray(syn.visible), np.asarray(syn.observations)
    sc = sfmdata.SfMData.empty()
    ii = sc.add_intrinsic(1000, 1920, 1080, 1200.0)
    for v in range(N_VIEWS):
        sc.add_view(100 + v, ii, 1920, 1080)
    scene_f = str(d / "scene.sfm")
    sfmdata.save(sc, scene_f)
    feats = str(d / "features")
    os.makedirs(feats)
    for v in range(N_VIEWS):
        np.savez_compressed(os.path.join(feats, f"{100 + v}.feat.npz"), xy=obs[v], scale=np.ones(N_POINTS),
                            orientation=np.zeros(N_POINTS), response=np.ones(N_POINTS),
                            desc=np.zeros((N_POINTS, 8), np.float32), valid=vis[v])
    matches = {}
    for i in range(N_VIEWS):
        for j in range(i + 1, N_VIEWS):
            common = np.nonzero(vis[i] & vis[j])[0]
            matches[f"{i}_{j}"] = np.stack([common, common], -1)
    matches_f = str(d / "matches.npz")
    np.savez_compressed(matches_f, **matches)
    return dict(d=str(d), scene=scene_f, feats=feats, matches=matches_f, syn=syn, obs=obs, vis=vis,
                matches_dict={(i, j): m for k, m in matches.items() for i, j in [map(int, k.split("_"))]})


def _ate(sc, syn):
    id2v = {int(vid): i for i, vid in enumerate(sc.view_ids)}
    est, gt = [], []
    for v in range(N_VIEWS):
        p = sc.view_pose[id2v[100 + v]]
        if p >= 0:
            est.append(sc.pose_c[p])
            gt.append(np.asarray(syn.poses.c[v]))
    est, gt = np.array(est), np.array(gt)
    s, R, t = umeyama_similarity(est, gt)
    return float(np.sqrt(np.mean(np.sum((est @ (s * R).T + t - gt) ** 2, 1))))


def _engines(setup):
    """A JAX engine bootstrapped by the JAX ExpansionProcess, and a port
    engine over the same tracks carrying its state."""
    nfeat = {v: N_POINTS for v in range(N_VIEWS)}
    xy = {v: setup["obs"][v] for v in range(N_VIEWS)}
    sc = sfmdata.load(setup["scene"])
    jtr = jbuild_tracks(setup["matches_dict"], nfeat, min_track_length=3)
    jsc = jsfm.load(setup["scene"])
    j = JEngine(jtr, xy, jsc.intrinsics_table(), view_intrinsic=jsc.view_intrinsic, image_sizes=jsc.view_sizes,
                config=JConfig(**CFG))
    assert jexp.ExpansionProcess(j).bootstrap()
    t = IncrementalSfM(build_tracks(setup["matches_dict"], nfeat, min_track_length=3), xy, sc.intrinsics_table(),
                       view_intrinsic=sc.view_intrinsic, image_sizes=sc.view_sizes,
                       config=IncrementalConfig(**CFG), device="cpu")
    return j, convert.carry_engine_state(j, t)


@pytest.fixture(scope="module")
def engines(setup):
    return _engines(setup)


def test_policies_match_from_one_state(engines):
    j, t = engines
    assert int(t.res.posed.sum()) == 2
    for cap in (30, 1):
        sel_t = texp.ExpansionPolicyLegacy(chunk_cap=cap).select(t)
        assert sel_t == jexp.ExpansionPolicyLegacy(chunk_cap=cap).select(j) and sel_t
    for dist in (0, 1):
        new = [int(np.nonzero(t.res.posed)[0][-1])]
        np.testing.assert_array_equal(texp.LbaPolicyConnexity(dist).fixed_mask(t, new),
                                      jexp.LbaPolicyConnexity(dist).fixed_mask(j, new))


def test_expansion_from_carried_state_and_checkpoint(setup, engines, tmp_path):
    _, t = engines
    ckpt = str(tmp_path / "ckpt.npz")
    history = texp.ExpansionHistory()
    res = texp.ExpansionProcess(t, history=history, checkpoint_path=ckpt).process()
    assert res.posed.all() and res.point_valid.sum() > 60
    assert [e["epoch"] for e in history.epochs] == list(range(len(history.epochs)))
    assert history.epochs[-1]["n_posed"] == N_VIEWS
    # a fresh engine restored from the checkpoint holds the same state, and
    # the process resumes it (augmentation: no new bootstrap)
    _, fresh = _engines(setup)
    texp.ExpansionHistory.load(fresh, ckpt)
    for name in ("pose_R", "pose_c", "posed", "points", "point_valid"):
        np.testing.assert_array_equal(getattr(fresh.res, name), getattr(t.res, name))
    np.testing.assert_array_equal(fresh.obs_inlier, t.obs_inlier)
    np.testing.assert_array_equal(fresh.obs_norm, t.obs_norm)
    assert texp.ExpansionProcess(fresh).bootstrap()
    assert texp.ExpansionIteration(fresh).process() == 0  # nothing left to add
