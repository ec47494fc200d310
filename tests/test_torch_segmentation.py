"""The port's segmentation (`misc/segmentation.py`) and `detect_sphere_onnx`
against the JAX package's, on the CPU, over authored `.onnx` models.

The tiling harness and the classical sky scorer are host copies: equal
arrays. `onnx_model` runs the port's executor on the caller's device; with
a graph that declares several outputs it gives the first, as ONNX
Runtime's `sess.run(None, ...)[0]` does, where the JAX wrapper stacks them
(ROADMAP §3) — that case is held to the first output, not to JAX. The
FCN of chip_smoke.py's `aux` phase is held to JAX at a narrow width (4
channels, one block a stage), its logits within 1e-5 of their scale.
"""

import numpy as np
import pytest
import torch

from alicevision_tpu.misc import segmentation as jseg
from alicevision_tpu.misc import sphere_detection as jsd
from alicevision_tpu.utils import onnx_rt as jrt
from alicevision_tpu_torch.misc import segmentation as tseg
from alicevision_tpu_torch.misc import sphere_detection as tsd
from alicevision_tpu_torch.utils.onnx_rt import OnnxModel, make_model, make_node

torch.set_num_threads(1)


def _write(path, data):
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def _blueness_model(path, side=128):
    """y = clip((2b - r - g) / 2 + 0.5, 0, 1) from 1x1 convs and elementwise ops
    (tests/test_onnx_native.py's model)."""
    w = {k: np.zeros((1, 3, 1, 1), np.float32) for k in ("w_r", "w_g", "w_b")}
    for c, k in enumerate(("w_r", "w_g", "w_b")):
        w[k][0, c] = 1.0
    nodes = [make_node("Conv", ["x", "w_b"], ["b"], kernel_shape=[1, 1]),
             make_node("Conv", ["x", "w_r"], ["r"], kernel_shape=[1, 1]),
             make_node("Conv", ["x", "w_g"], ["g"], kernel_shape=[1, 1]),
             make_node("Sub", ["b", "r"], ["br"]), make_node("Sub", ["b", "g"], ["bg"]),
             make_node("Add", ["br", "bg"], ["s2"]), make_node("Mul", ["s2", "half"], ["savg"]),
             make_node("Add", ["savg", "half"], ["shift"]), make_node("Clip", ["shift", "zero", "one"], ["y"])]
    inits = {**w, "half": np.asarray([0.5], np.float32), "zero": np.asarray([0.0], np.float32),
             "one": np.asarray([1.0], np.float32)}
    return _write(path, make_model(nodes, [("x", (1, 3, side, side))], [("y", (1, 1, side, side))], inits))


def _image(seed=0, hw=(200, 260)):
    rng = np.random.RandomState(seed)
    img = rng.rand(*hw, 3).astype(np.float32)
    img[:80] = [0.2, 0.3, 0.9]
    return img


def test_segment_tiled_over_onnx_matches(tmp_path):
    path = _blueness_model(tmp_path / "blueness.onnx")
    img = _image()
    got = tseg.segment_tiled(img, tseg.onnx_model(path, device="cpu"), tile=128, overlap=16)
    want = jseg.segment_tiled(img, jseg.onnx_model(path), tile=128, overlap=16)
    assert got.shape == (200, 260)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_segment_tiled_multiclass_and_classical_match():
    img = _image(1, (150, 170))

    def model(t):  # three classes from the channels, an exact per-pixel model
        return np.stack([t[..., 0] - t[..., 1], t[..., 2] * 0.5, t.mean(-1)], -1)

    np.testing.assert_array_equal(tseg.segment_tiled(img, model, 64, 8), jseg.segment_tiled(img, model, 64, 8))
    np.testing.assert_array_equal(tseg.sky_mask_classical(img), jseg.sky_mask_classical(img))
    np.testing.assert_array_equal(tseg.segment_sky(img, 0.3), jseg.segment_sky(img, 0.3))
    assert tseg.have_onnxruntime() == jseg.have_onnxruntime()


def test_multi_output_graph_gives_its_first_output(tmp_path):
    """Two declared outputs: the port's wrapper gives output 0 (ONNX Runtime's
    `sess.run(None, ...)[0]`); the JAX wrapper stacks the tuple into a 5-d
    array, which is the divergence ROADMAP §3 names."""
    w = np.zeros((2, 3, 1, 1), np.float32)
    w[0, 2], w[1, 0] = 1.0, 1.0
    data = make_model([make_node("Conv", ["x", "w"], ["y0"], kernel_shape=[1, 1]), make_node("Neg", ["y0"], ["y1"])],
                      [("x", (1, 3, 32, 32))], [("y0", (1, 2, 32, 32)), ("y1", (1, 2, 32, 32))], {"w": w})
    path = _write(tmp_path / "two.onnx", data)
    img = np.random.RandomState(0).rand(32, 32, 3).astype(np.float32)
    got = tseg.onnx_model(path, device="cpu")(img)
    np.testing.assert_allclose(got, img[..., [2, 0]], atol=1e-6)
    assert np.asarray(jseg.onnx_model(path)(img)).ndim == 5


def test_detect_sphere_onnx_matches(tmp_path):
    w = np.zeros((1, 3, 1, 1), np.float32)
    w[0, 2], w[0, 0] = 1.0, -1.0
    data = make_model([make_node("Conv", ["x", "w"], ["d"], kernel_shape=[1, 1]), make_node("Sigmoid", ["d"], ["y"])],
                      [("x", (1, 3, 160, 160))], [("y", (1, 1, 160, 160))], {"w": w})
    path = _write(tmp_path / "sphere.onnx", data)
    img = np.zeros((160, 160, 3), np.float32)
    yy, xx = np.mgrid[0:160, 0:160]
    img[(yy - 80) ** 2 + (xx - 90) ** 2 < 30**2] = [0.05, 0.2, 0.95]
    got = tsd.detect_sphere_onnx(img, path, threshold=0.6, device="cpu")
    want = jsd.detect_sphere_onnx(img, path, threshold=0.6)
    assert got is not None and np.allclose(got, want, atol=1e-6)
    assert abs(got[0] - 90) < 6 and abs(got[1] - 80) < 6
    assert tsd.detect_sphere_onnx(np.zeros((160, 160, 3), np.float32), path, threshold=0.6, device="cpu") is None


def test_fcn_layout_matches_jax(tmp_path):
    """chip_smoke.py's FCN writer at 4 channels and one block a stage, through
    both executors on a 64x64 tile and a 40x56 one: both heads' logits."""
    import chip_smoke

    path = str(tmp_path / "fcn.onnx")
    info = chip_smoke.fcn_resnet50_onnx(path, width=4, blocks=(1, 1, 1, 1), classes=5, seed=3)
    assert len(info["sha256"]) == 64
    rng = np.random.RandomState(0)
    port, ref = OnnxModel(path, device="cpu"), jrt.OnnxModel(path)
    for hw in ((64, 64), (40, 56)):
        x = rng.rand(1, 3, *hw).astype(np.float32)
        got, want = port(x), ref(x)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.shape == (1, 5, *hw)
            scale = max(1.0, float(np.abs(np.asarray(w)).max()))
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5 * scale, rtol=0)


def test_onnx_model_needs_cuda_without_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    path = _blueness_model(tmp_path / "b.onnx")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tseg.onnx_model(path)
    with pytest.raises(FileNotFoundError):
        tseg.onnx_model(str(tmp_path / "missing.onnx"), device="cpu")
