"""The port's SfM scene tools against the JAX package on the CPU: frustum
pairs (`sfm/frustum.py`, the separating-axis test batched on the device),
pose / intrinsics transfer, calibration, regression and distances
(`sfm/transfer.py`), merge and split (`sfmdata/merge.py`), the sample
scene (`utils/synthetic.ring_scene_sfmdata`) and the L-infinity LP solvers
(`lp/linfinity.py`).

The scenes are the JAX package's sample ring scene, saved once and loaded
by each package. Frustum pairs are held equal (the ring's frusta overlap
or miss by margins far above float32 rounding). The host tools are the
same numpy code: their scenes are saved by each package and the files held
byte-equal; the LP solvers' outputs are held equal. The sample scene takes
the JAX scene's points (the random streams differ): poses within 1e-6,
observations within 1e-3 px.
"""

import json

import numpy as np
import pytest
import torch

from alicevision_tpu import lp as jlp
from alicevision_tpu import sfmdata as jsd
from alicevision_tpu.sfm import frustum as jfr
from alicevision_tpu.sfm import transfer as jtr
from alicevision_tpu.sfmdata import merge as jmg
from alicevision_tpu.utils import synthetic as jsyn
from alicevision_tpu_torch import lp as tlp
from alicevision_tpu_torch import sfmdata as tsd
from alicevision_tpu_torch.sfm import frustum as tfr
from alicevision_tpu_torch.sfm import transfer as ttr
from alicevision_tpu_torch.sfmdata import merge as tmg
from alicevision_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two JAX sample scenes on disk: (ring of 10, ring of 8 with 4-px
    noise), and the folder."""
    root = tmp_path_factory.mktemp("tools")
    a = jsyn.ring_scene_sfmdata(n_views=10, n_points=120, seed=0)
    b = jsyn.ring_scene_sfmdata(n_views=8, n_points=80, noise_px=4.0, seed=1, focal_px=1100.0)
    jsd.save(a, str(root / "a.sfm"))
    jsd.save(b, str(root / "b.sfm"))
    return root


def _both(root, name):
    return jsd.load(str(root / name)), tsd.load(str(root / name))


def _same_files(root, j_scene, t_scene, name):
    jsd.save(j_scene, str(root / f"{name}_jax.sfm"))
    tsd.save(t_scene, str(root / f"{name}_torch.sfm"))
    assert (root / f"{name}_jax.sfm").read_bytes() == (root / f"{name}_torch.sfm").read_bytes()


@pytest.mark.parametrize("znf", [(None, None), (0.5, 3.0), (1.0, 20.0)])
def test_frustum_pairs(scenes, znf):
    sj, st = _both(scenes, "a.sfm")
    got = tfr.frustum_pairs(st, *znf, device="cpu")
    want = jfr.frustum_pairs(sj, *znf)
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got) <= 45
    if znf == (0.5, 3.0):  # short frusta: opposite cameras miss each other
        assert len(got) < 45
    _, corners = tfr.scene_frusta(st, *znf, device="cpu")
    np.testing.assert_allclose(corners.numpy(), np.asarray(jfr.scene_frusta(sj, *znf)[1]), atol=1e-5)


@pytest.mark.parametrize("by", ["viewId", "filename"])
def test_transfer(scenes, by):
    aj, at = _both(scenes, "a.sfm")
    bj, bt = _both(scenes, "b.sfm")
    assert ttr.transfer_poses(bt, at, match_by=by) == jtr.transfer_poses(bj, aj, match_by=by) > 0
    assert ttr.transfer_intrinsics(bt, at, match_by=by) == jtr.transfer_intrinsics(bj, aj, match_by=by) == 1
    _same_files(scenes, bj, bt, f"transfer_{by}")


def test_apply_calibration(scenes):
    calib = scenes / "calib.json"
    calib.write_text(json.dumps({"K": [[1010.0, 0, 950.0], [0, 1012.0, 545.0], [0, 0, 1]],
                                 "dist": [0.01, -0.002, 0.0005]}))
    for src in (str(calib), str(scenes / "b.sfm")):
        aj, at = _both(scenes, "a.sfm")
        assert ttr.apply_calibration(at, src) == jtr.apply_calibration(aj, src) == 1
        _same_files(scenes, aj, at, "calibrated")


def test_compare_scenes_and_distances(scenes):
    aj, at = _both(scenes, "a.sfm")
    bj, bt = _both(scenes, "b.sfm")
    for x, y in ((at, bt), (at, at)):
        xj, yj = (aj if x is at else bj), (aj if y is at else bj)
        assert ttr.compare_scenes(x, y) == jtr.compare_scenes(xj, yj)
    # a scene against itself: no centre moves; the angle floors at the
    # arccos of a trace a float32-rounded rotation puts just below 3
    rep = ttr.compare_scenes(at, at)
    assert rep["center_dist_max"] == 0.0 and rep["rotation_deg_max"] < 0.1
    ids = [int(i) for i in at.landmark_ids[:6]]
    args = (ids[:3] + [999999], ids[3:] + [ids[0]])
    assert ttr.landmark_distances(at, *args) == jtr.landmark_distances(aj, *args)


@pytest.mark.parametrize("align", [False, True])
def test_merge_and_split(scenes, align):
    aj, at = _both(scenes, "a.sfm")
    bj, bt = _both(scenes, "b.sfm")
    for s in (bj, bt):  # b's other views
        s.view_ids = s.view_ids + (1000 if not align else 0)
    mj, mt = jmg.merge_scenes(aj, bj, align=align), tmg.merge_scenes(at, bt, align=align)
    _same_files(scenes, mj, mt, f"merged_{align}")
    for s in (mj, mt):
        s.add_view(900, 0, 100, 100)
    (rj, nj), (rt, nt) = jmg.split_reconstructed(mj), tmg.split_reconstructed(mt)
    _same_files(scenes, rj, rt, "rec")
    _same_files(scenes, nj, nt, "non")
    assert nt.n_views == 1 and rt.n_views == mt.n_views - 1


def test_ring_scene_sfmdata():
    ref = jsyn.ring_scene_sfmdata(n_views=6, n_points=50, seed=3)
    pts = np.asarray(jsyn.ring_scene(n_views=6, n_points=50, seed=3).points)
    got = tsyn.ring_scene_sfmdata(n_views=6, n_points=50, seed=3, points=pts, device="cpu")
    for k in ("view_ids", "view_paths", "view_frames", "intrinsic_ids", "obs_landmark", "obs_view", "landmark_ids"):
        np.testing.assert_array_equal(np.asarray(getattr(got, k)), np.asarray(getattr(ref, k)))
    np.testing.assert_allclose(got.pose_R, ref.pose_R, atol=1e-6)
    np.testing.assert_allclose(got.pose_c, ref.pose_c, atol=1e-6)
    np.testing.assert_array_equal(got.points, ref.points)
    np.testing.assert_allclose(got.obs_uv, ref.obs_uv, atol=1e-3)
    drawn = tsyn.ring_scene_sfmdata(n_views=6, n_points=50, seed=3, device="cpu")
    assert drawn.n_landmarks == 50 and drawn.n_observations > 100


def _ring_P(n=5, radius=4.0):
    Ps = []
    for k in range(n):
        c = radius * np.array([np.cos(2 * np.pi * k / n), np.sin(2 * np.pi * k / n), 0.0])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        Ps.append(np.concatenate([R, (-R @ c)[:, None]], axis=1))
    return np.array(Ps)


def test_linfinity():
    rng = np.random.default_rng(0)
    Ps = _ring_P()
    X = np.array([0.3, -0.2, 0.4])
    x = Ps @ np.append(X, 1.0)
    uv = x[:, :2] / x[:, 2:] + rng.uniform(-1e-3, 1e-3, (5, 2))
    for a, b in zip(tlp.triangulate_linf(Ps, uv), jlp.triangulate_linf(Ps, uv)):
        np.testing.assert_array_equal(a, b)
    world = rng.normal(size=(12, 3)) * 0.5
    xw = np.c_[world, np.ones(12)] @ Ps[0].T
    uvw = xw[:, :2] / xw[:, 2:]
    for a, b in zip(tlp.resection_linf(world, uvw), jlp.resection_linf(world, uvw)):
        np.testing.assert_array_equal(a, b)
    centers = rng.normal(size=(5, 3))
    edges = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    dirs = [(centers[j] - centers[i]) / np.linalg.norm(centers[j] - centers[i]) for i, j in edges]
    for a, b in zip(tlp.translations_from_relative_linf(5, edges, dirs),
                    jlp.translations_from_relative_linf(5, edges, dirs)):
        np.testing.assert_array_equal(a, b)
