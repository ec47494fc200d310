"""Photographs through the port's stages on the CPU: JPEG bytes with EXIF
into cameraInit (no default focal: EXIF -> sensor database -> focal in
pixels) and featureExtraction, against the JAX package's stages; and the
same path with PIL, imageio and cv2 blocked, which is the card machine's
case (it has no image codec library).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from alicevision_tpu import sfmdata as jsfm
from alicevision_tpu.pipeline import stages as jstages
from alicevision_tpu_torch import native, sfmdata
from alicevision_tpu_torch.image import exif, jpeg
from alicevision_tpu_torch.image import io as tio
from alicevision_tpu_torch.pipeline import stages
from alicevision_tpu_torch.utils.rendered import render_views

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAKE, MODEL, SENSOR_MM = "Canon", "Canon EOS 5D Mark III", 36.0  # the JAX photo test's camera


def _photos(folder: str, n: int, wh=(320, 240), focal_px: float = 280.0, focal_in: str = "ifd0") -> np.ndarray:
    """n rendered views as quality-95 JPEGs (grey made RGB, as the JAX
    photo test writes them) with Make, Model and FocalLength."""
    imgs, *_ = render_views(n, wh, focal_px=focal_px, arc=0.3, seed=0)
    os.makedirs(folder, exist_ok=True)
    app1 = exif.exif_app1(MAKE, MODEL, focal_px * SENSOR_MM / wh[0], "MM", focal_in)
    for v in range(n):
        u8 = np.clip(imgs[v] * 255.0, 0, 255).astype(np.uint8)
        data = exif.insert_app1(jpeg.encode(np.dstack([u8] * 3), 95), app1)
        with open(os.path.join(folder, f"view_{v:03d}.jpg"), "wb") as f:
            f.write(data)
    return imgs


def test_camera_init_matches_jax(tmp_path):
    """Four JPEGs with the focal in IFD0: the same views and intrinsics as
    the JAX cameraInit, the focal from EXIF within 0.5 % of the render's."""
    folder = str(tmp_path / "imgs")
    _photos(folder, 4)
    ours = stages.camera_init(folder, str(tmp_path / "port.sfm"), device="cpu")
    ref = jstages.camera_init(folder, str(tmp_path / "jax.sfm"))
    for got, want in zip(ours.intrinsics_table(), ref.intrinsics_table()):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(ours.view_intrinsic, np.asarray(ref.view_intrinsic))
    np.testing.assert_array_equal(ours.view_sizes, np.asarray(ref.view_sizes))
    assert ours.view_paths == list(ref.view_paths)
    assert abs(float(ours.scale[0, 0]) - 280.0) / 280.0 < 0.005
    assert sfmdata.load(str(tmp_path / "port.sfm")).n_views == jsfm.load(str(tmp_path / "jax.sfm")).n_views == 4


def test_camera_init_reads_sub_ifd_focal(tmp_path):
    """The focal in the Exif sub-IFD: the port's cameraInit derives it; the
    JAX one misses it and falls back to 1.2 x the width."""
    folder = str(tmp_path / "imgs")
    _photos(folder, 2, focal_in="exif")
    ours = stages.camera_init(folder, str(tmp_path / "port.sfm"), device="cpu")
    ref = jstages.camera_init(folder, str(tmp_path / "jax.sfm"))
    assert float(ours.scale[0, 0]) == pytest.approx(280.0, rel=1e-5)
    assert float(np.asarray(ref.scale)[0, 0]) == pytest.approx(1.2 * 320)


def test_feature_extraction_jpeg_equals_npy(tmp_path):
    """featureExtraction on a JPEG view gives the features of the `.npy`
    path of the same decoded pixels."""
    folder, npy_folder = str(tmp_path / "imgs"), str(tmp_path / "npy")
    _photos(folder, 1)
    os.makedirs(npy_folder)
    jpg = os.path.join(folder, "view_000.jpg")
    np.save(os.path.join(npy_folder, "view_000.npy"), tio.read_image(jpg))
    feats = {}
    for name, src in (("jpg", folder), ("npy", npy_folder)):
        scene = str(tmp_path / f"{name}.sfm")
        stages.camera_init(src, scene, default_focal_px=280.0, device="cpu")
        stages.feature_extraction(scene, str(tmp_path / f"f_{name}"), max_keypoints=512, device="cpu")
        feats[name] = stages.load_features(str(tmp_path / f"f_{name}"), 1)
    assert len(feats["jpg"]["xy"]) > 100
    for key in feats["jpg"]:
        np.testing.assert_array_equal(feats["jpg"][key], feats["npy"][key], err_msg=key)


def test_jpeg_raises_without_the_codec(tmp_path, monkeypatch):
    """A failed build raises from read_image; the file never reaches
    imageio."""
    path = str(tmp_path / "a.jpg")
    tio.write_image(path, np.zeros((8, 8, 3), np.float32))

    def no_compiler(*a, **k):
        raise RuntimeError("no C++ compiler (g++) found: the JPEG codec needs one to build")

    import imageio.v2 as imageio

    monkeypatch.setattr(native, "_JPEG", None)
    monkeypatch.setattr(native, "build", no_compiler)
    monkeypatch.setattr(imageio, "imread", lambda *a, **k: pytest.fail("a JPEG went to imageio"))
    with pytest.raises(RuntimeError, match="JPEG codec"):
        tio.read_image(path)
    with pytest.raises(RuntimeError, match="JPEG codec"):
        tio.write_image(str(tmp_path / "b.jpg"), np.zeros((8, 8), np.float32))


_NO_CODECS = r"""
import os, sys
for name in ("PIL", "imageio", "cv2"):
    sys.modules[name] = None  # import raises ImportError, as on a machine without them
import numpy as np, torch
torch.set_num_threads(1)
from alicevision_tpu_torch.image import exif, io as tio
from alicevision_tpu_torch.pipeline import stages
folder = sys.argv[1]
os.makedirs(folder)
rng = np.random.default_rng(0)
src = rng.random((48, 64, 3)).astype(np.float32)
for v in range(3):
    path = os.path.join(folder, f"v{v}.jpg")
    tio.write_image(path, src)
    with open(path, "rb") as f:
        data = exif.insert_app1(f.read(), exif.exif_app1("Canon", "Canon EOS 5D Mark III", 31.5))
    with open(path, "wb") as f:
        f.write(data)
img = tio.read_image(path)
assert img.shape == (48, 64, 3) and img.dtype == np.float32 and np.abs(img - src).mean() < 0.2
assert tio.read_image(path, grayscale=True).shape == (48, 64)
assert tio.read_exif(path) == {"width": 64, "height": 48, "make": "Canon", "model": "Canon EOS 5D Mark III",
                               "focal_mm": 31.5}
sc = stages.camera_init(folder, os.path.join(folder, "scene.sfm"), device="cpu")
assert sc.n_views == 3 and abs(float(sc.scale[0, 0]) - 31.5 * 64 / 36.0) < 1e-3, sc.scale
assert not any(m in sys.modules and sys.modules[m] is not None for m in ("PIL", "imageio", "cv2"))
print("ok")
"""


def test_photos_without_codec_libraries(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _NO_CODECS, str(tmp_path / "imgs")], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stdout + res.stderr


def _passing_row() -> dict:
    """A photos row that meets every gate (the shape of run_photos_phase's)."""
    return {
        "fixtures": {"fixtures": 13, "misses": []},
        "photo_24mp": {"shape_ok": True, "psnr_db": 43.49, "crop_plain_equal": True},
        "pipeline": {"views": 8, "camera_init_focal_px": 1120.0, "depth_maps": 8, "n_posed": 8, "posed": list(range(1, 9)),
                     "sgm_launches": {"sgm_directional_pass": 0, "sgm_axis_sweeps": 32},
                     "ate_frac_of_radius": 0.002, "rotation_err_deg": [0.1] * 8, "landmarks": 240,
                     "depth_median_rel_err": [0.02] * 8, "depth_valid_frac": [0.4] * 8, "cloud_points": 90000},
        "hard": {"views": 40, "posed": 40, "ate_frac_of_radius": 0.004, "focal_px": [452.0, 451.0],
                 "focal_true": 450.0, "k1": -0.24, "exif_focal_px": 450.0},
    }


def test_photos_phase_parts_and_gates(tmp_path):
    """chip_smoke.py's photos phase on the CPU at small sizes: the fixtures
    against PIL's hashes, a round trip with its crop held to the plain
    decoder, camera JPEGs read back with their EXIF; and its gates, each
    fault planted in a passing row named by photos_misses."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    fixtures = chip_smoke.check_jpeg_fixtures()
    assert fixtures["misses"] == [] and fixtures["fixtures"] >= 10
    rt = chip_smoke.photo_round_trip((96, 64), crop=32)
    assert rt["shape_ok"] and rt["crop_plain_equal"] and rt["psnr_db"] > 30
    imgs = np.random.default_rng(0).random((2, 24, 40)).astype(np.float32)
    mm = chip_smoke.write_photos(str(tmp_path / "p"), imgs, 1120.0 * 40 / 1280)
    meta = tio.read_exif(str(tmp_path / "p" / "view_001.jpg"))
    assert meta["focal_mm"] == pytest.approx(mm) and meta["model"] == chip_smoke.PHOTO_CAMERA[1]
    assert np.abs(tio.read_image(str(tmp_path / "p" / "view_000.jpg"), grayscale=True) - imgs[0]).mean() < 0.05

    assert chip_smoke.photos_misses(_passing_row()) == []
    faults = [
        (("fixtures", "misses"), ["s420.jpg: the C++ decode is not PIL's"], "s420.jpg"),
        (("photo_24mp", "psnr_db"), 40.0, "24 MP round trip"),
        (("photo_24mp", "crop_plain_equal"), False, "crop"),
        (("pipeline", "camera_init_focal_px"), 1200.0, "cameraInit focal"),
        (("pipeline", "sgm_launches"), {"sgm_directional_pass": 0, "sgm_axis_sweeps": 28}, "SGM launches"),
        (("pipeline", "n_posed"), 6, "views posed"),
        (("pipeline", "depth_maps"), 7, "7 depth maps"),
        (("pipeline", "ate_frac_of_radius"), 0.02, "ATE"),
        (("pipeline", "rotation_err_deg"), [0.1] * 7 + [2.1], "rotation errors"),
        (("pipeline", "cloud_points"), 100, "cloud.ply"),
        (("hard", "posed"), 37, "hard photos: 37 of 40"),
        (("hard", "k1"), -0.05, "k1"),
        (("hard", "exif_focal_px"), 480.0, "EXIF focal"),
    ]
    for (part, key), value, words in faults:
        row = _passing_row()
        row[part][key] = value
        misses = chip_smoke.photos_misses(row)
        assert len(misses) >= 1 and any(words in m for m in misses), (part, key, misses)
