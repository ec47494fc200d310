"""The port's homography-growing filter against the JAX package's, on the
CPU.

Inputs are tests/test_hgrowing.py's scenes (numpy from a seed): two planes
with outliers, pure noise, one identity plane, too few matches. Tolerances:
  * `grow_from_seeds`: every seed's H within rtol 1e-3 of JAX's (relative
    to its largest entry), the inlier masks equal except for matches whose
    transfer error lies within 1e-3 of the tolerance's square;
  * `filter_matches_hgrowing`: the same assignment, homographies within
    rtol 1e-3;
  * the float64 route a card takes for the DLT's null vector gives the same
    growth on the CPU;
  * the `homography_growing` branch of featureMatching writes the same
    matches as the JAX stage on the same features (the port's SIFT of a
    rendered 3-view scene).
"""

import os

import numpy as np
import pytest
import torch

from alicevision_tpu.matching import hgrowing as jh
from alicevision_tpu.pipeline import stages as jst
from alicevision_tpu_torch.matching import hgrowing as th
from alicevision_tpu_torch.pipeline import stages as tst
from alicevision_tpu_torch.utils.rendered import render_views
from test_hgrowing import _two_plane_scene

torch.set_num_threads(1)

H_RTOL = 1e-3
BOUNDARY = 1e-3  # share of tol^2 around the inlier boundary where masks may differ


def _noise(n=60, seed=1):
    rng = np.random.RandomState(seed)
    return rng.uniform(0, 640, (n, 2)), rng.uniform(0, 640, (n, 2)), np.ones(n), np.ones(n), np.zeros(n), np.zeros(n)


def _identity(n=50, seed=2):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 500, (n, 2))
    return xy, xy + rng.normal(0, 0.1, (n, 2)), np.ones(n), np.ones(n), np.zeros(n), np.zeros(n)


SCENES = {
    "two_planes_0": lambda: _two_plane_scene(seed=0)[:6],
    "two_planes_3": lambda: _two_plane_scene(seed=3)[:6],
    "noise": _noise,
    "identity": _identity,
    "too_few": lambda: _identity(n=4),
}


def _grow_both(scene):
    import jax.numpy as jnp

    xyI, xyJ, sI, sJ, oI, oJ = scene
    n = len(xyI)
    ids = np.round(np.linspace(0, n - 1, min(n, 256))).astype(np.int32)
    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    ref = [np.asarray(a) for a in jh.grow_from_seeds(f(xyI), f(xyJ), f(sI), f(sJ), f(oI), f(oJ), jnp.ones(n, bool),
                                                    jnp.asarray(ids))]
    g = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    out = [a.numpy() for a in th.grow_from_seeds(g(xyI), g(xyJ), g(sI), g(sJ), g(oI), g(oJ),
                                                 torch.ones(n, dtype=torch.bool), torch.as_tensor(ids))]
    return ref, out


def _hold_growth(ref, out, scene):
    (Hj, inj, cj), (Ht, int_, ct) = ref, out
    scale = np.abs(Hj).max((1, 2), keepdims=True)
    np.testing.assert_allclose(Ht / scale, Hj / scale, atol=H_RTOL)
    xyI, xyJ = (np.asarray(a, np.float64) for a in scene[:2])
    ph = xyI @ Hj[:, :, :2].transpose(0, 2, 1) + Hj[:, None, :, 2]
    err2 = ((ph[..., :2] / ph[..., 2:] - xyJ) ** 2).sum(-1)
    tol2 = th.HGrowingParams().homography_tolerance ** 2
    differ = int_ != inj
    assert not (differ & (np.abs(err2 - tol2) > BOUNDARY * tol2)).any()
    np.testing.assert_array_equal(ct, int_.sum(1))


@pytest.mark.parametrize("name", ["two_planes_0", "two_planes_3", "noise", "identity"])
def test_grow_from_seeds_matches(name):
    scene = SCENES[name]()
    ref, out = _grow_both(scene)
    _hold_growth(ref, out, scene)


def test_float64_null_vector_route(monkeypatch):
    """A card's DLT route (formed and decomposed in float64) grows the same
    planes as JAX's float32 on the two-plane scene."""
    scene = SCENES["two_planes_0"]()
    monkeypatch.setattr(th, "_dlt_nullvector", th._dlt_nullvector64)
    ref, out = _grow_both(scene)
    _hold_growth(ref, out, scene)


@pytest.mark.parametrize("name", list(SCENES))
def test_filter_matches_hgrowing_assignment(name):
    scene = SCENES[name]()
    params = jh.HGrowingParams(max_seeds=60) if name == "noise" else jh.HGrowingParams()
    hj, aj, ij = jh.filter_matches_hgrowing(*scene, params)
    ht, at, it = th.filter_matches_hgrowing(*scene, th.HGrowingParams(**params._asdict()), device="cpu")
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_array_equal(it, ij)
    assert ht.shape == hj.shape
    if len(hj):
        scale = np.abs(hj).max((1, 2), keepdims=True)
        np.testing.assert_allclose(ht / scale, hj / scale, atol=H_RTOL)


def test_homography_growing_branch(tmp_path):
    """featureMatching --geometricFilterType homography_growing: the port's
    stage keeps the matches the JAX stage keeps, on the same features."""
    imgs, *_ = render_views(3, (320, 240), focal_px=300.0, arc=0.2, seed=0)
    os.makedirs(tmp_path / "images")
    for v in range(3):
        np.save(tmp_path / "images" / f"{v:02d}.npy", imgs[v])
    sfm, feats, pairs = (str(tmp_path / f) for f in ("c.sfm", "features", "pairs.txt"))
    tst.camera_init(str(tmp_path / "images"), sfm, default_focal_px=300.0, device="cpu")
    tst.feature_extraction(sfm, feats, max_keypoints=512, downscale_to=0, device="cpu")
    tst.image_matching(sfm, feats, pairs, method="exhaustive", device="cpu")
    jst.feature_matching(sfm, feats, pairs, str(tmp_path / "mj.npz"), geometric="homography_growing")
    tst.feature_matching(sfm, feats, pairs, str(tmp_path / "mt.npz"), geometric="homography_growing", device="cpu")
    with np.load(tmp_path / "mj.npz") as a, np.load(tmp_path / "mt.npz") as b:
        assert a.files == b.files and len(a.files) == 3
        kept = 0
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k])
            kept += len(a[k])
    assert kept > 60
