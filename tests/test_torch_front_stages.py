"""The port's SfM front end — cameraInit → featureExtraction →
imageMatching → featureMatching — against the JAX package's stages, on the
CPU.

Both packages run their stages on one rendered 4-view 320x240 scene
(`utils/rendered.render_views`, written as `.npy` images); the port with
`device="cpu"`. The files they write are compared: the `.sfm` JSON, the
features (as tests/test_torch_sift.py compares them), each package's
`load_features` on the other's files, `pairs.txt`, and `matches.npz` of the
photometric pass on one features folder. The port's geometric filter is
held against the scene's true epipolar geometry (Sampson distance). The JAX stages run once.
"""

import json
import os

import chip_smoke
import numpy as np
import pytest
import torch

from alicevision_tpu.pipeline import stages as jst
from alicevision_tpu_torch.features import sift as tsift
from alicevision_tpu_torch.image.filtering import _resize_bilinear
from alicevision_tpu_torch.pipeline import stages as tst
from alicevision_tpu_torch.utils.rendered import render_views

torch.set_num_threads(1)

N_VIEWS, WH, FOCAL = 4, (320, 240), 300.0
MAX_KP = 512


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Render the scene, run both packages' four stages, return the paths."""
    root = tmp_path_factory.mktemp("front")
    imgs, _, K, R, c = render_views(N_VIEWS, WH, focal_px=FOCAL, arc=0.2, seed=0)
    img_dir = root / "images"
    img_dir.mkdir()
    for v in range(N_VIEWS):
        np.save(img_dir / f"{v:02d}.npy", imgs[v])
    p = {}
    for name, st, kw in (("jax", jst, {}), ("torch", tst, {"device": "cpu"})):
        d = root / name
        d.mkdir()
        q = {k: str(d / f) for k, f in
             (("sfm", "cameraInit.sfm"), ("feats", "features"), ("pairs", "pairs.txt"),
              ("matches", "matches_none.npz"))}
        st.camera_init(str(img_dir), q["sfm"], default_focal_px=FOCAL, **kw)
        st.feature_extraction(q["sfm"], q["feats"], max_keypoints=MAX_KP, downscale_to=0, **kw)
        st.image_matching(q["sfm"], q["feats"], q["pairs"], method="exhaustive", **kw)
        p[name] = q
    # the photometric pass of both packages on the JAX features
    for name, st, kw in (("jax", jst, {}), ("torch", tst, {"device": "cpu"})):
        st.feature_matching(p["jax"]["sfm"], p["jax"]["feats"], p["jax"]["pairs"],
                            p[name]["matches"], geometric="none", **kw)
    p["root"], p["K"], p["R"], p["c"], p["imgs"] = root, K, R, c, imgs
    return p


def test_camera_init_same_sfm(run):
    with open(run["jax"]["sfm"]) as f:
        a = json.load(f)
    with open(run["torch"]["sfm"]) as f:
        b = json.load(f)
    assert a == b
    assert len(b["views"]) == N_VIEWS and len(b["intrinsics"]) == 1


def test_features_agree(run):
    n_checked = 0
    for vid in range(1, N_VIEWS + 1):
        fj = jst.load_features(run["jax"]["feats"], vid)
        ft = tst.load_features(run["torch"]["feats"], vid)
        vj, vt = fj["valid"], ft["valid"]
        assert abs(int(vt.sum()) - int(vj.sum())) <= max(1, 0.02 * vj.sum())
        d = np.linalg.norm(fj["xy"][vj][:, None] - ft["xy"][vt][None], axis=-1)
        near, dist = d.argmin(1), d.min(1)
        sc_j, sc_t = fj["scale"][vj], ft["scale"][vt][near]
        dori = np.abs(np.angle(np.exp(1j * (ft["orientation"][vt][near] - fj["orientation"][vj]))))
        same = (dist < 0.01) & (np.abs(sc_t - sc_j) <= 1e-4 * sc_j) & (dori < 1e-3)
        assert same.mean() >= 0.98
        # uint8 descriptors: a float difference of 1e-4 may cross a
        # quantization step (1/512)
        with np.load(os.path.join(run["torch"]["feats"], f"{vid}.feat.npz")) as z:
            du_t = z["desc"]
        with np.load(os.path.join(run["jax"]["feats"], f"{vid}.feat.npz")) as z:
            du_j = z["desc"]
        assert du_t.dtype == du_j.dtype == np.uint8 and du_t.shape == du_j.shape
        diff = np.abs(du_t[vt][near].astype(int) - du_j[vj].astype(int))[same]
        assert diff.max() <= 1
        n_checked += int(same.sum())
    assert n_checked >= 200


def test_load_features_reads_other_package(run):
    for src in ("jax", "torch"):
        for vid in range(1, N_VIEWS + 1):
            a = jst.load_features(run[src]["feats"], vid)
            b = tst.load_features(run[src]["feats"], vid)
            assert sorted(a) == sorted(b) == ["desc", "orientation", "response", "scale", "valid", "xy"]
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_pairs_identical(run):
    with open(run["jax"]["pairs"]) as f:
        a = f.read()
    with open(run["torch"]["pairs"]) as f:
        b = f.read()
    assert a == b and len(a.splitlines()) == 6
    np.testing.assert_array_equal(tst.load_pairs(run["torch"]["pairs"]), jst.load_pairs(run["jax"]["pairs"]))
    # the port's other methods: sequential, and a vocabulary tree whose
    # neighbour count covers every other view (so every pair)
    q = run["torch"]
    for method, kw in (("sequential", {"n_neighbors": 1}), ("voctree", {"n_neighbors": 3, "tree_levels": 2})):
        out = str(run["root"] / f"pairs_{method}.txt")
        pairs = tst.image_matching(q["sfm"], q["feats"], out, method=method, device="cpu", **kw)
        want = [[0, 1], [1, 2], [2, 3]] if method == "sequential" else jst.load_pairs(run["jax"]["pairs"]).tolist()
        assert pairs.tolist() == want


def test_photometric_matches_identical(run):
    a = jst.load_matches(run["jax"]["matches"])
    b = tst.load_matches(run["torch"]["matches"])
    assert sorted(a) == sorted(b) and len(a) == 6
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert min(len(a[(i, i + 1)]) for i in range(N_VIEWS - 1)) >= 30


def _fundamental_true(K, R, c, i, j):
    """F of the rendered views in pixel-array coordinates: pixel (x, y)
    holds the ray through (x + 0.5, y + 0.5) of K."""
    Kp = K.copy()
    Kp[:2, 2] -= 0.5
    Rr = R[j] @ R[i].T
    tr = R[j] @ (c[i] - c[j])
    tx = np.array([[0, -tr[2], tr[1]], [tr[2], 0, -tr[0]], [-tr[1], tr[0], 0]])
    Ki = np.linalg.inv(Kp)
    return Ki.T @ tx @ Rr @ Ki


def test_geometric_inliers_on_true_epipolar_lines(run):
    q = run["torch"]
    out = str(run["root"] / "matches_f.npz")
    tst.feature_matching(q["sfm"], q["feats"], q["pairs"], out, device="cpu")
    m = tst.load_matches(out)
    photo = tst.load_matches(run["torch"]["matches"])
    feats = {v: tst.load_features(q["feats"], v + 1) for v in range(N_VIEWS)}
    for i in range(N_VIEWS - 1):
        pm = m[(i, i + 1)]
        assert len(pm) >= 30 and len(pm) <= len(photo[(i, i + 1)])
        F = _fundamental_true(run["K"], run["R"], run["c"], i, i + 1)
        d = chip_smoke.epipolar_px(F, feats[i]["xy"][pm[:, 0]], feats[i + 1]["xy"][pm[:, 1]])
        assert (d < 2.0).mean() >= 0.95, np.sort(d)[-5:]


def test_resize_path(run, tmp_path):
    """featureExtraction through the resize (downscale_to below the image
    size): the resize equals cv2.resize, and the keypoints come back in the
    full image's pixels."""
    import cv2
    img = run["imgs"][0]
    size = (256, 192)
    np.testing.assert_allclose(
        _resize_bilinear(torch.from_numpy(run["imgs"]), size).numpy()[0], cv2.resize(img, size), atol=1e-5
    )
    feats = str(tmp_path / "feats")
    tst.feature_extraction(run["torch"]["sfm"], feats, max_keypoints=MAX_KP, downscale_to=256,
                           range_size=1, device="cpu")
    assert tst.extraction_host_copies == 1
    got = tst.load_features(feats, 1)
    ref = tsift.extract(torch.from_numpy(cv2.resize(img, size)), tsift.SiftConfig(max_keypoints=MAX_KP, n_octaves=4))
    v = ref.valid.numpy()
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_allclose(got["xy"][v], ref.xy.numpy()[v] / 0.8, atol=1e-3)
    np.testing.assert_allclose(got["scale"][v], ref.scale.numpy()[v] / 0.8, rtol=1e-4)


def test_front_stages_raise_without_cuda_or_for_unported(run, tmp_path):
    q = run["torch"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tst.camera_init(str(run["root"] / "images"), str(tmp_path / "c.sfm"))
        with pytest.raises(RuntimeError, match="CUDA"):
            tst.feature_extraction(q["sfm"], str(tmp_path / "f"))
        with pytest.raises(RuntimeError, match="CUDA"):
            tst.image_matching(q["sfm"], q["feats"], str(tmp_path / "p.txt"))
        with pytest.raises(RuntimeError, match="CUDA"):
            tst.feature_matching(q["sfm"], q["feats"], q["pairs"], str(tmp_path / "m.npz"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tst.feature_extraction(q["sfm"], str(tmp_path / "f"), describer_types="akaze", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tst.feature_extraction(q["sfm"], str(tmp_path / "f"), describer_types="sift,tag16h5", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tst.image_matching(q["sfm"], q["feats"], str(tmp_path / "p.txt"), method="frustum", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tst.feature_matching(q["sfm"], q["feats"], q["pairs"], str(tmp_path / "m.npz"),
                             geometric="homography_growing", device="cpu")


def test_chip_smoke_front_phase_on_cpu(tmp_path):
    """chip_smoke.py's front-end phase at a small size: its posed scene,
    its stage driver (through the resize path) and its report, whose true
    epipolar geometry agrees with the one above."""
    sfm, _ = chip_smoke.make_posed_scene(str(tmp_path), n_views=3, wh=WH, focal_px=FOCAL, arc=0.2,
                                         n_points=200)
    res = chip_smoke.run_front(str(tmp_path / "front"), str(tmp_path / "images"), "cpu",
                               focal_px=FOCAL, max_keypoints=MAX_KP, downscale_to=288)
    assert set(res["seconds"]) == {"cameraInit", "featureExtraction", "imageMatching", "featureMatching"}
    assert res["extraction_batches"] == 1
    rep = chip_smoke.front_report(res, sfm, 3)
    assert min(rep["keypoints_per_view"]) >= 60
    assert min(rep["adjacent_inliers"]) >= 20
    assert rep["frac_within_2px_of_true_epipolar"] >= chip_smoke.FRONT_EPI_FRAC
    _, _, K, R, c = render_views(3, WH, focal_px=FOCAL, arc=0.2, seed=0)
    np.testing.assert_allclose(chip_smoke.fundamental_true(sfm, 0, 2), _fundamental_true(K, R, c, 0, 2),
                               rtol=1e-6, atol=1e-12)
