"""The seven subcommands of ROADMAP item 13 (d) through the port's `cli.main`
(`--device cpu`) against the JAX CLI on the same inputs.

imageMasking (HSV and Otsu over a folder, one photograph grown and shrunk)
and imageSegmentation (the classical scorer, a one-channel `.onnx`) write
equal masks; sfmColorHarmonize's images agree within one 8-bit step plus
the float32 solve's spread (the two IRLS solves differ by up to ~1e-3 in a
gain, tests/test_torch_masking_harmonize.py); importE57, lidarMerging,
lidarDecimating and lidarMeshing write the JAX CLI's bytes (PLY, JSON,
`.npy`, OBJ) and print its JSON. imageSegmentation with a multi-class
`.onnx` follows the C++ contract instead (labelsToMask: the pixels whose
argmax label is class 0), where the JAX CLI thresholds class 0's raw score
(ROADMAP §3); that case is held to the contract and the divergence shown.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from alicevision_tpu.pipeline import cli as jcli
from alicevision_tpu_torch.image.io import read_image
from alicevision_tpu_torch.pipeline import cli as tcli
from alicevision_tpu_torch.utils.onnx_rt import make_model, make_node

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


def _both(tmp_path, name, argv_of):
    """Run `name` through both CLIs; argv_of(out_dir) gives its arguments.
    Returns (port dir, JAX dir, port stdout, JAX stdout)."""
    outs = []
    for tag, main, extra in (("port", tcli.main, CPU), ("jax", jcli.main, [])):
        d = tmp_path / tag
        os.makedirs(d, exist_ok=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main([name, *argv_of(d), *extra])
        assert rc == 0, (tag, name)
        outs.append((d, buf.getvalue()))
    return outs[0][0], outs[1][0], outs[0][1], outs[1][1]


def _mask(path):
    return read_image(str(path)) > 0.5


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    import chip_smoke

    root = tmp_path_factory.mktemp("aux_cli")
    views = root / "views"
    os.makedirs(views)
    rng = np.random.RandomState(0)
    np.save(views / "a.npy", chip_smoke.aux_photo((96, 64), seed=2))
    np.save(views / "b.npy", rng.rand(64, 96).astype(np.float32))  # grayscale
    np.save(views / "c.npy", chip_smoke.aux_photo((96, 64), seed=3).mean(-1))
    photo = root / "photo.npy"
    np.save(photo, chip_smoke.aux_photo((200, 150), seed=0))
    return root, views, photo


def test_image_masking_matches(inputs, tmp_path):
    root, views, photo = inputs
    port, jax_, pp, jp = _both(tmp_path / "hsv", "imageMasking",
                               lambda d: ["--input", str(views), "--output", str(d / "m"), "--hsvMin", "0,0,0.3",
                                          "--hsvMax", "1,1,0.8"])
    port2, jax2, _, _ = _both(tmp_path / "auto", "imageMasking",
                              lambda d: ["--input", str(views), "--output", str(d / "m"), "--algorithm",
                                         "autoGrayscaleThreshold", "--invert"])
    port3, jax3, _, _ = _both(tmp_path / "photo", "imageMasking",
                              lambda d: ["--input", str(photo), "--output", str(d / "sky.png"), "--hsvMin",
                                         "0.5,0.2,0.3", "--hsvMax", "0.75,1,1", "--growRadius", "2",
                                         "--shrinkRadius", "3"])
    assert pp == jp == '{"masks": 3}\n'
    for a, b in ((port / "m", jax_ / "m"), (port2 / "m", jax2 / "m")):
        names = sorted(os.listdir(a))
        assert names == sorted(os.listdir(b)) == ["a_mask.png", "b_mask.png", "c_mask.png"]
        for n in names:
            assert np.array_equal(_mask(a / n), _mask(b / n)), n
    got, want = _mask(port3 / "sky.png"), _mask(jax3 / "sky.png")
    assert np.array_equal(got, want) and 0 < got.sum() < got.size


def _model(path, classes):
    """A 1x1-conv scorer: one channel (blueness) or `classes` channels."""
    w = np.zeros((classes, 3, 1, 1), np.float32)
    w[0, 2], w[0, 0] = 1.0, -1.0
    for k in range(1, classes):
        w[k, k % 3] = 0.6
    data = make_model([make_node("Conv", ["x", "w"], ["y"], kernel_shape=[1, 1])], [("x", (1, 3, 64, 64))],
                      [("y", (1, classes, 64, 64))], {"w": w})
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def test_image_segmentation_matches(inputs, tmp_path):
    root, _, photo = inputs
    port, jax_, _, _ = _both(tmp_path / "sky", "imageSegmentation",
                             lambda d: ["--input", str(photo), "--output", str(d / "sky.png")])
    assert np.array_equal(_mask(port / "sky.png"), _mask(jax_ / "sky.png"))
    one = _model(tmp_path / "one.onnx", 1)
    port, jax_, _, _ = _both(tmp_path / "one", "imageSegmentation",
                             lambda d: ["--input", str(photo), "--modelPath", one, "--threshold", "0.2",
                                        "--output", str(d / "m.png")])
    got = _mask(port / "m.png")
    assert np.array_equal(got, _mask(jax_ / "m.png")) and 0 < got.sum() < got.size


def test_image_segmentation_multiclass_takes_argmax_labels(inputs, tmp_path):
    """Several classes: the mask is the pixels labelled class 0 by argmax
    (labelsToMask), not class 0's raw score over --threshold."""
    from alicevision_tpu.misc.segmentation import onnx_model, segment_tiled

    root, _, photo = inputs
    three = _model(tmp_path / "three.onnx", 3)
    port, jax_, _, _ = _both(tmp_path / "three", "imageSegmentation",
                             lambda d: ["--input", str(photo), "--modelPath", three, "--output", str(d / "m.png")])
    scores = segment_tiled(np.load(photo)[..., :3], onnx_model(three))
    labels_class0 = np.argmax(scores, axis=-1) == 0
    got = _mask(port / "m.png")
    assert np.array_equal(got, labels_class0) and 0 < got.sum() < got.size
    assert np.array_equal(_mask(jax_ / "m.png"), scores[..., 0] > 0.35)
    assert not np.array_equal(got, _mask(jax_ / "m.png"))  # the divergence


def test_sfm_color_harmonize_matches(tmp_path):
    from alicevision_tpu_torch.image.io import write_image
    from alicevision_tpu_torch.pipeline import stages as tst
    from alicevision_tpu_torch.utils.render import make_test_dataset

    imgs = tmp_path / "imgs"
    make_test_dataset(str(imgs), n_views=3, wh=(240, 180), focal=200.0)
    files = sorted(os.listdir(imgs))
    tgt = str(imgs / files[2])
    write_image(tgt, np.clip(read_image(tgt, grayscale=True) * 1.4, 0, 1))
    scene, feats, pairs, matches = (str(tmp_path / f) for f in ("s.sfm", "feats", "pairs.txt", "m.npz"))
    tst.camera_init(str(imgs), scene, default_focal_px=200.0, device="cpu")
    tst.feature_extraction(scene, feats, max_keypoints=1024, downscale_to=0, device="cpu")
    tst.image_matching(scene, feats, pairs, method="exhaustive", device="cpu")
    tst.feature_matching(scene, feats, pairs, matches, device="cpu")
    port, jax_, pp, jp = _both(tmp_path / "h", "sfmColorHarmonize",
                               lambda d: ["--input", scene, "--features", feats, "--matches", matches,
                                          "--imagesFolder", str(imgs), "--output", str(d / "out")])
    assert pp == jp == '{"views": 3}\n'
    names = sorted(os.listdir(port / "out"))
    assert names == sorted(os.listdir(jax_ / "out")) and len(names) == 3
    for n in names:
        a, b = read_image(str(port / "out" / n)), read_image(str(jax_ / "out" / n))
        assert np.abs(a - b).max() <= 1 / 255 + 2e-3, n
    h = [read_image(str(port / "out" / n)).mean() for n in names]
    assert abs(h[2] - h[0]) < 0.08  # the brightened view pulled back


def test_lidar_chain_and_import_e57_bytes(tmp_path):
    import chip_smoke

    lidar_in = chip_smoke.make_lidar_inputs(str(tmp_path), samples=(48, 24))
    printed = {}
    for name, argv in chip_smoke.lidar_chain("OUT", lidar_in, 0.3):
        port, jax_, pp, jp = _both(tmp_path, name, lambda d: [a.replace("OUT", str(d)) for a in argv])
        assert pp == jp, name
        printed[name] = json.loads(pp)
    for f in ("imported.json", "imported_scan0.ply", "merged.ply", "merged_origins.npy", "decimated.ply",
              "decimated_origins.npy", "mesh.obj"):
        assert (port / f).read_bytes() == (jax_ / f).read_bytes(), f
    assert printed["lidarMerging"] == {"points": 3 * 48 * 24, "scans": 3}
    assert printed["importE57"] == {"scans": 1, "points": 48 * 24} and printed["lidarMeshing"]["faces"] > 100
