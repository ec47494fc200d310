"""The port's image filtering and similarity volumes against the JAX
reference, on the CPU, on a rendered box-world scene at 80x60."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu.image import filtering as jf
from alicevision_tpu.mvs import plane_sweep as jps
from alicevision_tpu.mvs import rectified as jr
from alicevision_tpu.utils.rendered import render_views
from alicevision_tpu_torch.image import filtering as tf
from alicevision_tpu_torch.mvs import plane_sweep as tps
from alicevision_tpu_torch.mvs import rectified as tr

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


@pytest.fixture(scope="module")
def scene():
    imgs, _, K, R, c = render_views(n_views=3, wh=(80, 60), focal_px=70.0, arc=0.3)
    K = K.astype(np.float32)

    def rel(t, rc=0, R=R, c=c):
        return (
            (R[t] @ R[rc].T).astype(np.float32),
            (R[t] @ (c[rc] - c[t])).astype(np.float32),
        )

    (R1, t1), (R2, t2) = rel(1), rel(2)
    # a tcam moved along the reference's view axis: rectification degenerates
    # there, so "auto" sends this pair through the gather path
    fwd = R[0][2]
    R3 = np.eye(3, dtype=np.float32)
    t3 = (R[0] @ (c[0] - (c[0] + 0.4 * fwd))).astype(np.float32)
    assert jr.rectification_ok(R1, t1) and jr.rectification_ok(R2, t2)
    assert not jr.rectification_ok(R3, t3)
    depths = (1.0 / np.linspace(1 / 10.0, 1 / 3.0, 16))[::-1].astype(np.float32).copy()
    return {
        "imgs": imgs, "K": K, "R": np.stack([R1, R2, R3]), "t": np.stack([t1, t2, t3]),
        "depths": depths,
    }


# Blur and sampling are the same float32 sums in another order: 1e-6 on
# [0, 1] images.
@pytest.mark.parametrize("sigma", [1.0, 2.0])
def test_gaussian_blurs_match(sigma):
    img = np.random.RandomState(0).rand(3, 30, 40).astype(np.float32)
    out = tf.gaussian_blur(_t(img), sigma).numpy()
    np.testing.assert_allclose(out, np.asarray(jf.gaussian_blur(_j(img), sigma)), atol=1e-6)
    out_mm = tf.gaussian_blur_mm(_t(img), sigma).numpy()
    np.testing.assert_allclose(out_mm, np.asarray(jf.gaussian_blur_mm(_j(img), sigma)), atol=1e-6)
    k = tf.gaussian_kernel_1d(sigma).numpy()
    np.testing.assert_allclose(k, np.asarray(jf.gaussian_kernel_1d(sigma)), atol=1e-7)


def test_bilinear_sample_matches():
    rng = np.random.RandomState(1)
    img = rng.rand(30, 40).astype(np.float32)
    xy = (rng.rand(7, 50, 2) * [44, 34] - 2).astype(np.float32)  # some outside
    for fill in (0.0, -1.0):
        out = tf.bilinear_sample(_t(img), _t(xy), fill).numpy()
        np.testing.assert_allclose(out, np.asarray(jf.bilinear_sample(_j(img), _j(xy), fill)), atol=1e-6)


def test_homography_warp_and_zncc_match(scene):
    K, R1, t1 = scene["K"], scene["R"][0], scene["t"][0]
    Hj = np.asarray(jps.plane_homography(_j(K), _j(K), _j(R1), _j(t1), 5.0))
    Ht = tps.plane_homography(_t(K), _t(K), _t(R1), _t(t1), 5.0).numpy()
    np.testing.assert_allclose(Ht, Hj, rtol=1e-5, atol=1e-5)
    img_t, img_r = scene["imgs"][1], scene["imgs"][0]
    wj, vj = jps.warp_homography(_j(img_t), _j(Hj), (60, 80))
    wt, vt = tps.warp_homography(_t(img_t), _t(Hj), (60, 80))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-6)
    # ZNCC divides by windowed variances, which magnifies the blur's
    # rounding: 1e-3 on the [-1, 1] scale
    zj = jps.zncc(_j(img_r), wj, vj, 2.0)
    zt = tps.zncc(_t(img_r), _t(np.asarray(wj)), _t(np.asarray(vj)), 2.0)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-3)


def _both(fn_j, fn_t, scene, tcams, **kw):
    """Run the JAX and port functions on the same tcams of the scene."""
    imgs, K, d = scene["imgs"], scene["K"], scene["depths"]
    tidx = [min(t, 1) + 1 for t in tcams]  # image of tcam 0 -> view 1, else view 2
    T = len(tcams)
    args = (
        imgs[0], imgs[tidx], np.stack([K] * T), scene["R"][tcams], scene["t"][tcams], d,
    )
    ref = fn_j(_j(args[0]), _j(args[1]), _j(K), *(_j(a) for a in args[2:]), **kw)
    out = fn_t(_t(args[0]), _t(args[1]), _t(K), *(_t(a) for a in args[2:]), **kw)
    return out.numpy(), np.asarray(ref)


# Costs on the 0..255 scale: ZNCC magnifies float32 differences of the blur
# (banded product vs XLA conv) and the inverse FFT (irfft vs DFT product);
# measured up to ~8e-3 at this size, held at 0.05.
COST_ATOL = 0.05


def test_similarity_volume_gather_matches(scene):
    tc = np.array([[3.5, 9.0], [3.0, 6.0]], np.float32)
    out, ref = _both(
        lambda *a, **k: jps.similarity_volume(*a, jps.SgmParams(depth_chunk=5), **k),
        lambda *a, **k: tps.similarity_volume(*a, tps.SgmParams(depth_chunk=5), **k),
        scene, [0, 1], tc_depth_ranges=tc,
    )
    assert out.shape == (16, 60, 80)
    np.testing.assert_allclose(out, ref, atol=COST_ATOL)


def test_pair_similarity_rectified_matches(scene):
    imgs, K, d = scene["imgs"], scene["K"], scene["depths"]
    R1, t1 = scene["R"][0], scene["t"][0]
    ref = jr.pair_similarity_rectified(
        _j(imgs[0]), _j(imgs[1]), _j(K), _j(K), _j(R1), _j(t1), _j(d),
        jps.SgmParams(rect_depth_chunk=6),
    )
    out = tr.pair_similarity_rectified(
        _t(imgs[0]), _t(imgs[1]), _t(K), _t(K), _t(R1), _t(t1), _t(d),
        tps.SgmParams(rect_depth_chunk=6),
    )
    # similarity on [-1, 1]: 1e-3 (measured ~1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3)


@pytest.mark.parametrize(
    "tcams,branch",
    [([0, 1], "all-rectified"), ([2], "all-gather"), ([0, 2], "mixed")],
)
def test_similarity_volume_auto_branches_match(scene, tcams, branch):
    ok = [jr.rectification_ok(scene["R"][t], scene["t"][t]) for t in tcams]
    assert {"all-rectified": all(ok), "all-gather": not any(ok), "mixed": any(ok) and not all(ok)}[branch]
    tc = np.tile(np.array([[3.2, 9.5]], np.float32), (len(tcams), 1))
    out, ref = _both(
        lambda *a, **k: jr.similarity_volume_auto(*a, jps.SgmParams(), **k),
        lambda *a, **k: tr.similarity_volume_auto(*a, tps.SgmParams(), **k),
        scene, tcams, tc_depth_ranges=tc,
    )
    assert out.shape == (16, 60, 80) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=COST_ATOL)
