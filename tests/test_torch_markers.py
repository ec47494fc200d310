"""The port's marker describers (`features/markers.py`, a host copy of the
JAX package's numpy module) and featureExtraction's `tag16h5` / `cctag3`
branch against the JAX package on the CPU.

The detectors are the same numpy code, so their detections on rendered
tags (axis-aligned, rotated, several of each family) are held equal. The
stage writes `<viewId>.tag16h5.npz` / `.cctag3.npz` from the images as
read (byte-equal arrays to the JAX stage's) and, above `downscale_to`,
from the resized image: the port resizes with its OpenCV-equal bilinear
where the JAX stage calls cv2.resize (equal within 1e-5), so there the
ids are held equal and the centres within 0.05 px.
"""

import os

import numpy as np
import pytest
import torch
from scipy import ndimage

from alicevision_tpu.features import markers as jmk
from alicevision_tpu.pipeline import stages as jst
from alicevision_tpu_torch.features import markers as tmk
from alicevision_tpu_torch.pipeline import stages as tst

torch.set_num_threads(1)


def _place(canvas, patch, y, x):
    h, w = patch.shape
    canvas[y:y + h, x:x + w] = patch
    return canvas


def _image(kind: int) -> np.ndarray:
    if kind == 0:  # two tags, two rings
        img = np.ones((360, 480), np.float32)
        _place(img, jmk.render_apriltag(3, 96), 20, 30)
        _place(img, jmk.render_apriltag(17, 80), 200, 60)
        _place(img, jmk.render_cctag(0, 121), 20, 300)
        _place(img, jmk.render_cctag(9, 97), 220, 330)
        return img
    base = np.ones((260, 260), np.float32)  # a rotated tag
    _place(base, jmk.render_apriltag(7, 128), 60, 60)
    return ndimage.rotate(base, 25, reshape=False, cval=1.0, order=1).astype(np.float32)


def _same(a, b):
    assert [d.marker_id for d in a] == [d.marker_id for d in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.center, y.center)
        assert x.scale == y.scale
        assert (x.corners is None) == (y.corners is None)
        if x.corners is not None:
            np.testing.assert_array_equal(x.corners, y.corners)


@pytest.mark.parametrize("kind", [0, 1])
def test_detections_equal(kind):
    img = _image(kind)
    _same(tmk.detect_apriltags(img), jmk.detect_apriltags(img))
    _same(tmk.detect_cctags(img), jmk.detect_cctags(img))
    if kind == 0:
        assert sorted(d.marker_id for d in tmk.detect_apriltags(img)) == [3, 17]
        assert {0, 9} <= {d.marker_id for d in tmk.detect_cctags(img)}
    dets = tmk.detect_apriltags(img)
    for a, b in zip(tmk.markers_to_features(dets), jmk.markers_to_features(jmk.detect_apriltags(img))):
        np.testing.assert_array_equal(a, b)


def test_renderers_and_bank_equal():
    np.testing.assert_array_equal(tmk.render_apriltag(11, 64), jmk.render_apriltag(11, 64))
    np.testing.assert_array_equal(tmk.render_cctag(5, 65), jmk.render_cctag(5, 65))
    np.testing.assert_array_equal(tmk.cctag_bank(), jmk.cctag_bank())


@pytest.fixture(scope="module")
def marker_scene(tmp_path_factory):
    """Two .npy views with markers and both packages' cameraInit scenes."""
    root = tmp_path_factory.mktemp("markers")
    img_dir = root / "images"
    img_dir.mkdir()
    np.save(img_dir / "00.npy", _image(0))
    np.save(img_dir / "01.npy", np.pad(_image(1), ((50, 50), (110, 110)), constant_values=1.0))
    sfm = {}
    for name, st, kw in (("jax", jst, {}), ("torch", tst, {"device": "cpu"})):
        sfm[name] = str(root / f"{name}.sfm")
        st.camera_init(str(img_dir), sfm[name], default_focal_px=400.0, **kw)
    return root, sfm


@pytest.mark.parametrize("downscale_to", [0, 400])
def test_stage_marker_files(marker_scene, downscale_to):
    root, sfm = marker_scene
    out = {}
    for name, st, kw in (("jax", jst, {}), ("torch", tst, {"device": "cpu"})):
        out[name] = str(root / f"{name}_{downscale_to}")
        st.feature_extraction(sfm[name], out[name], downscale_to=downscale_to, describer_types="tag16h5,cctag3",
                              **kw)
    files = sorted(os.listdir(out["jax"]))
    assert files == sorted(os.listdir(out["torch"]))
    assert len(files) == 4 and not any(f.endswith(".feat.npz") for f in files)
    n_ids = 0
    for f in files:
        with np.load(os.path.join(out["jax"], f)) as a, np.load(os.path.join(out["torch"], f)) as b:
            assert sorted(a.files) == sorted(b.files) == ["desc", "ids", "orientation", "scale", "xy"]
            np.testing.assert_array_equal(b["ids"], a["ids"])
            np.testing.assert_array_equal(b["desc"], a["desc"])
            n_ids += len(a["ids"])
            if downscale_to:
                np.testing.assert_allclose(b["xy"], a["xy"], atol=0.05)
                np.testing.assert_allclose(b["scale"], a["scale"], atol=0.05)
            else:
                for k in a.files:
                    np.testing.assert_array_equal(b[k], a[k])
    assert n_ids >= 5
