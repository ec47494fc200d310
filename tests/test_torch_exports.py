"""The port's scene exports, statistics, alignment, colorization and PNG
codec against the JAX package's, on the CPU.

Both packages load the same `.sfm` (a 6-view synthetic ring with four
intrinsics of different distortion models, one view unposed). The text
exports must be byte-equal (their quaternions go through float32 in both
packages); `import_colmap` equal; `scene_statistics` and
`reprojection_residuals` within rtol 1e-5 (float32 projections on two
backends); the alignment routines (host numpy in both) within 1e-9; the
colorized cloud, the PLY and BAF exports equal. The port writes PNG without
imageio: imageio reads back exactly the pixels the JAX writer (imageio)
writes, and the port's reader reads imageio's 8-bit PNGs exactly (other
variants, such as 16-bit, go through imageio in both packages).
"""

import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from alicevision_tpu import camera as jcam
from alicevision_tpu import sfmdata as jsfm
from alicevision_tpu.image import io as jio
from alicevision_tpu.sfm import alignment as jal
from alicevision_tpu.sfm import statistics as jst
from alicevision_tpu.sfmdata import export as jexp
from alicevision_tpu.utils.synthetic import ring_scene
from alicevision_tpu_torch import sfmdata as tsfm
from alicevision_tpu_torch.image import io as tio
from alicevision_tpu_torch.sfm import alignment as tal
from alicevision_tpu_torch.sfm import statistics as tst
from alicevision_tpu_torch.sfmdata import export as texp

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    """A ring scene with noisy (0.3 px) observations of the undistorted
    projection, registered with four intrinsics that differ from it, saved
    once."""
    d = tmp_path_factory.mktemp("exports")
    syn = ring_scene(n_views=6, n_points=40, noise_px=0.3, seed=2)
    sc = jsfm.SfMData.empty()
    kinds = [(jcam.DISTO_NONE, ()), (jcam.DISTO_RADIALK1, (-0.05,)),
             (jcam.DISTO_RADIALK3, (-0.1, 0.01, -0.001)), (jcam.DISTO_BROWN, (-0.1, 0.01, 0.001, 1e-4, -2e-4))]
    for k, (dk, dp) in enumerate(kinds):
        sc.add_intrinsic(1000 + k, 1920, 1080, 1200.0 + 10 * k, disto_kind=dk, disto_params=dp,
                         offset=(3.0 - k, -2.0 + k), focal_y_px=1201.0 + 10 * k)
    R, c = np.asarray(syn.poses.R, np.float64), np.asarray(syn.poses.c, np.float64)
    for v in range(6):
        vi = sc.add_view(100 + v, v % 4, 1920, 1080, path=f"/img/{v}.jpg", frame_id=5 - v)
        if v != 4:
            sc.set_pose(vi, R[v], c[v])
    vis, obs = np.asarray(syn.visible), np.asarray(syn.observations, np.float64)
    lm, view = np.nonzero(vis.T)
    sc.set_structure(np.asarray(syn.points, np.float64), lm, view, obs[view, lm],
                     colors=(np.arange(120).reshape(40, 3) * 2).astype(np.uint8))
    path = str(d / "scene.sfm")
    jsfm.save(sc, path)
    return path


def _both(path):
    return jsfm.load(path), tsfm.load(path)


def _tree_bytes(root):
    out = {}
    for dp, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(dp, f), "rb") as fh:
                out[os.path.relpath(os.path.join(dp, f), root)] = fh.read()
    return out


@pytest.mark.parametrize("name", ["colmap", "meshlab", "mve2", "pmvs", "usd", "animated_camera"])
def test_exports_byte_equal(scene_file, tmp_path, name):
    js, ts = _both(scene_file)
    mesh = (np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0.5]]), np.array([[0, 1, 2]]))
    for tag, mod, sc in (("jax", jexp, js), ("port", texp, ts)):
        out = str(tmp_path / tag / ("out.usda" if name == "usd" else "anim.json" if name == "animated_camera"
                                    else "out"))
        os.makedirs(os.path.dirname(out), exist_ok=True)
        if name == "meshlab":
            mod.export_meshlab(sc, out, "mesh.obj")
        elif name == "usd":
            mod.export_usd(sc, out, mesh=mesh)
        elif name == "animated_camera":
            mod.export_animated_camera(sc, out, fps=25.0)
        else:
            getattr(mod, f"export_{name}")(sc, out)
    a, b = _tree_bytes(tmp_path / "jax"), _tree_bytes(tmp_path / "port")
    assert a and a == b


def test_import_colmap_and_known_poses_match(scene_file, tmp_path):
    js, _ = _both(scene_file)
    jexp.export_colmap(js, str(tmp_path / "colmap"))
    a, b = jexp.import_colmap(str(tmp_path / "colmap")), texp.import_colmap(str(tmp_path / "colmap"))
    for field in ("view_ids", "view_intrinsic", "view_pose", "view_sizes", "intrinsic_ids", "disto_kind", "scale",
                  "offset", "sizes", "disto", "pose_R", "pose_c"):
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field), err_msg=field)
    assert b.view_paths == a.view_paths
    jexp.export_animated_camera(js, str(tmp_path / "anim.json"))
    ja, ta = _both(scene_file)
    assert jexp.import_known_poses(ja, str(tmp_path / "anim.json")) == texp.import_known_poses(
        ta, str(tmp_path / "anim.json")) == 5
    np.testing.assert_array_equal(ta.pose_R, ja.pose_R)


def test_statistics_match(scene_file, tmp_path):
    js, ts = _both(scene_file)
    rj = jst.reprojection_residuals(js)
    rt = tst.reprojection_residuals(ts, device="cpu")
    np.testing.assert_allclose(rt, rj, rtol=1e-5, atol=1e-6)
    assert len(rt) == (ts.view_pose[ts.obs_view] >= 0).sum() and np.median(rt) > 0.05
    sj, stt = jst.scene_statistics(js), tst.scene_statistics(ts, device="cpu")
    for key in ("n_views", "n_posed", "n_intrinsics", "n_landmarks", "n_observations", "track_length",
                "observations_per_view"):
        assert stt[key] == sj[key], key
    for key, val in sj["residuals_px"].items():
        np.testing.assert_allclose(stt["residuals_px"][key], val, rtol=1e-5)
    jst.generate_html_report(js, str(tmp_path / "j.html"))
    tst.generate_html_report(ts, str(tmp_path / "t.html"), device="cpu")
    with open(tmp_path / "j.html") as a, open(tmp_path / "t.html") as b:
        assert a.read() == b.read()


def test_alignment_matches(scene_file):
    js, ts = _both(scene_file)
    rng = np.random.RandomState(0)
    src = rng.randn(12, 3)
    ang = 0.3
    Rz = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    dst = 2.0 * src @ Rz.T + [1.0, -2.0, 0.5]
    dst[:2] += 5.0  # two outliers for the robust fit
    for fn in ("umeyama_similarity", "robust_similarity"):
        for a, b in zip(getattr(tal, fn)(src, dst), getattr(jal, fn)(src, dst)):
            np.testing.assert_allclose(a, b, atol=1e-9)
    ref_j, ref_t = _both(scene_file)
    for sc in (ref_j, ref_t):
        sc.pose_c = sc.pose_c @ (1.7 * Rz).T + 0.3
    np.testing.assert_allclose(tal.ate_rmse(ts, ref_t), jal.ate_rmse(js, ref_j), atol=1e-9)
    for a, b in zip(tal.align_to_scene(ts, ref_t), jal.align_to_scene(js, ref_j)):
        np.testing.assert_allclose(a, b, atol=1e-9)
    for a, b in zip(tal.auto_center_scale(ts, 2.0), jal.auto_center_scale(js, 2.0)):
        np.testing.assert_allclose(a, b, atol=1e-9)
    for field in ("pose_R", "pose_c", "points"):
        np.testing.assert_allclose(getattr(ts, field), getattr(js, field), atol=1e-9)
    llh = {100 + v: (47.0 + 1e-4 * v, 8.5 + 2e-4 * (v % 3), 400.0 + v) for v in range(6)}
    for a, b in zip(tal.align_from_gps(ts, llh), jal.align_from_gps(js, llh)):
        np.testing.assert_allclose(a, b, atol=1e-9, rtol=1e-12)
    for sc in (ts, js):
        sc.desc_types = ["tag16h5"] * 4 + ["sift"] * (sc.n_landmarks - 4)
        for li in range(4):
            sc.obs_feature[sc.obs_landmark == li] = 100 + li
    markers = {100 + li: js.points[li] * 3.0 + 1.0 for li in range(4)}
    for a, b in zip(tal.align_from_markers(ts, markers), jal.align_from_markers(js, markers)):
        np.testing.assert_allclose(a, b, atol=1e-9)


def test_colored_cloud_ply_and_baf_match(scene_file, tmp_path):
    js, ts = _both(scene_file)
    rng = np.random.RandomState(1)
    imgs = {v: rng.rand(1080, 1920, 3).astype(np.float32) if v % 2 else rng.rand(1080, 1920).astype(np.float32)
            for v in range(6)}
    np.testing.assert_array_equal(tsfm.colorize_tracks(ts, imgs.__getitem__),
                                  jsfm.colorize_tracks(js, imgs.__getitem__))
    for ext in (".ply", ".baf"):
        jsfm.save(js, str(tmp_path / f"j{ext}"))
        tsfm.save(ts, str(tmp_path / f"t{ext}"))
    for a, b in (("j.ply", "t.ply"), ("j.baf", "t.baf"), ("j_imgList.txt", "t_imgList.txt")):
        with open(tmp_path / a, "rb") as fa, open(tmp_path / b, "rb") as fb:
            assert fa.read() == fb.read(), a
    folder = tmp_path / "dense"
    folder.mkdir()
    for v in range(6):
        np.save(folder / f"{100 + v}.npy", imgs[v])
    np.testing.assert_array_equal(tsfm.npy_folder_loader(ts, str(folder))(3), imgs[3])


@pytest.mark.parametrize("shape,dtype", [((37, 53), np.float32), ((37, 53, 3), np.float64), ((20, 11, 4), np.uint8),
                                         ((9, 7, 2), np.uint8), ((16, 24), np.uint16)])  # uint16: through imageio
def test_png_writer_matches_imageio(tmp_path, shape, dtype):
    rng = np.random.default_rng(len(shape) + shape[0])
    if dtype == np.uint8:
        img = rng.integers(0, 256, shape).astype(np.uint8)
    elif dtype == np.uint16:
        img = rng.integers(0, 65536, shape).astype(np.uint16)
    else:
        img = (rng.random(shape) * 1.2 - 0.1).astype(dtype)  # clipped to [0, 1] by the writers
    jio.write_image(str(tmp_path / "j.png"), img)
    tio.write_image(str(tmp_path / "t.png"), img)
    a, b = imageio.imread(tmp_path / "j.png"), imageio.imread(tmp_path / "t.png")
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(tio.read_image(str(tmp_path / "t.png")), jio.read_image(str(tmp_path / "j.png")))


def test_png_reader_reads_imageio_exactly(tmp_path):
    """imageio (PIL) picks a filter per row (Sub, Up, Paeth on smooth and
    noisy rows); the Average filter is written by hand."""
    import struct
    import zlib

    rng = np.random.default_rng(5)
    y, x = np.mgrid[0:64, 0:80]
    smooth = ((np.sin(x / 5) + np.cos(y / 7)) * 60 + 120 + rng.random((64, 80)) * 20).astype(np.uint8)
    for img in (smooth, np.stack([smooth, smooth[::-1], 255 - smooth], -1),
                np.dstack([smooth, smooth[:, ::-1], smooth, smooth // 2])):
        imageio.imwrite(tmp_path / "i.png", img)
        np.testing.assert_array_equal(tio.read_png(str(tmp_path / "i.png")), imageio.imread(tmp_path / "i.png"))
    img = rng.integers(0, 256, (9, 7, 3)).astype(np.uint8)
    rows, prev = [], np.zeros(21, np.int32)
    for r in img.reshape(9, 21).astype(np.int32):
        left = np.concatenate([np.zeros(3, np.int32), r[:-3]])
        rows.append(b"\x03" + ((r - ((left + prev) >> 1)) & 0xFF).astype(np.uint8).tobytes())
        prev = r
    with open(tmp_path / "avg.png", "wb") as f:
        f.write(tio._PNG_SIG + tio._png_chunk(b"IHDR", struct.pack(">IIBBBBB", 7, 9, 8, 2, 0, 0, 0))
                + tio._png_chunk(b"IDAT", zlib.compress(b"".join(rows))) + tio._png_chunk(b"IEND", b""))
    np.testing.assert_array_equal(imageio.imread(tmp_path / "avg.png"), img)
    np.testing.assert_array_equal(tio.read_png(str(tmp_path / "avg.png")), img)
