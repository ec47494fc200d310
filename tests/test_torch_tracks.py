"""The port's track builder (`tracks/builder.py`) and tracksBuilding stage
against the JAX reference on the CPU.

Tracks are numbered by the union-find's root labels, so the port must
reproduce the reference's native union-find (union by size, path halving)
exactly: its `Tracks` arrays are held equal bit for bit — on a random
match graph with forks and short tracks, and on the matches.npz that the
port's front stages write for a rendered 4-view scene (both packages'
tracksBuilding stages on the same files).
"""

import numpy as np
import pytest
import torch

from alicevision_tpu.native import connected_components
from alicevision_tpu.pipeline import stages as jst
from alicevision_tpu.tracks import builder as jtb
from alicevision_tpu_torch.pipeline import stages as tst
from alicevision_tpu_torch.tracks import builder as ttb
from alicevision_tpu_torch.utils.rendered import render_views

torch.set_num_threads(1)


def _assert_same(a, b):
    assert a.n_tracks == b.n_tracks
    for name in ("track_ids", "views", "features"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_union_find_roots():
    """The same root label for every node as the reference's native
    union-find, on random edge lists."""
    rng = np.random.RandomState(0)
    for n in (1, 17, 500, 4000):
        a, b = rng.randint(0, n, 3 * n), rng.randint(0, n, 3 * n)
        np.testing.assert_array_equal(ttb._union_find(a, b, n), connected_components(a, b, n))


@pytest.mark.parametrize("min_len", [2, 3])
def test_build_tracks_random_graph(min_len):
    """6 views of 300 features; 15 pairs of random matches, with chained
    views (long tracks), forks (two features of one view in a track) and
    empty pairs."""
    rng = np.random.RandomState(1)
    nfeat = {v: 300 for v in range(6)}
    matches = {}
    for i in range(6):
        for j in range(i + 1, 6):
            k = 0 if (i, j) == (1, 4) else 120
            m = np.stack([rng.choice(300, k, replace=False), rng.choice(300, k, replace=False)], 1)
            matches[(i, j)] = m
    tr_j = jtb.build_tracks(matches, nfeat, min_track_length=min_len)
    tr_t = ttb.build_tracks(matches, nfeat, min_track_length=min_len)
    _assert_same(tr_t, tr_j)
    np.testing.assert_array_equal(tr_t.lengths(), tr_j.lengths())
    np.testing.assert_array_equal(ttb.tracks_in_views(tr_t, [0, 2, 5]), jtb.tracks_in_views(tr_j, [0, 2, 5]))
    xy = {v: rng.rand(300, 2) * 1000 for v in range(6)}
    np.testing.assert_array_equal(ttb.observations_table(tr_t, xy), jtb.observations_table(tr_j, xy))
    # forks were dropped: no track holds a view twice
    key = tr_t.track_ids.astype(np.int64) * 6 + tr_t.views
    assert len(np.unique(key)) == len(key)


def test_build_tracks_empty():
    tr = ttb.build_tracks({(0, 1): np.zeros((0, 2), np.int64)}, {0: 10, 1: 10})
    _assert_same(tr, jtb.build_tracks({(0, 1): np.zeros((0, 2), np.int64)}, {0: 10, 1: 10}))


def test_tracks_building_stage_on_front_matches(tmp_path):
    """The port's front stages on a rendered 4-view 320x240 scene, then
    both packages' tracksBuilding on the same files: equal tracks.npz."""
    imgs, _, _, _, _ = render_views(4, (320, 240), focal_px=300.0, arc=0.2, seed=0)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for v in range(4):
        np.save(img_dir / f"{v:02d}.npy", imgs[v])
    p = {k: str(tmp_path / f) for k, f in (("sfm", "cameraInit.sfm"), ("feats", "features"),
                                           ("pairs", "pairs.txt"), ("matches", "matches.npz"))}
    tst.camera_init(str(img_dir), p["sfm"], default_focal_px=300.0, device="cpu")
    tst.feature_extraction(p["sfm"], p["feats"], max_keypoints=512, downscale_to=0, device="cpu")
    tst.image_matching(p["sfm"], p["feats"], p["pairs"], method="exhaustive", device="cpu")
    tst.feature_matching(p["sfm"], p["feats"], p["pairs"], p["matches"], device="cpu")
    out_j, out_t = str(tmp_path / "tracks_jax.npz"), str(tmp_path / "tracks_torch.npz")
    jst.tracks_building(p["sfm"], p["feats"], p["matches"], out_j)
    tst.tracks_building(p["sfm"], p["feats"], p["matches"], out_t, device="cpu")
    with np.load(out_j) as zj, np.load(out_t) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype, k
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
        assert int(zt["n_tracks"]) > 20
