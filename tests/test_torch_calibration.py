"""The port's calibration and distortion modules (`camera/undistortion`,
`camera/convert`, `calibration/{checkerboard,zhang,distortion_lines}`,
`numeric.eigh64`) against the JAX reference on the CPU.

Inputs follow tests/test_{undistortion,calibration,cli_ext3,
merge_distortion_sphere}.py, seeded: the four 3DE undistortion models'
parameters, boards rendered under a perspective warp and under radial
distortion with noise and shading (`_render_board`'s), a frame of the
smoke's board shoot at 640x360, and synthetic calibration views. The JAX
functions run eagerly on the CPU (float32); the port takes its small
decompositions and normal equations in float64, so its iterative fits are
held to the reference's results within stated tolerances, not bits:
warps 1e-6, Newton inverses 1e-5 (normalized) and 1e-3 px, corner grids
1e-3 px, K within rtol 1e-4, distortion coefficients within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu import camera as jcam
from alicevision_tpu.calibration import checkerboard as jcb
from alicevision_tpu.calibration import distortion_lines as jdl
from alicevision_tpu.calibration import zhang as jzh
from alicevision_tpu.camera import convert as jcv
from alicevision_tpu.camera import undistortion as jund
from alicevision_tpu_torch import camera as cam
from alicevision_tpu_torch.calibration import checkerboard as cb
from alicevision_tpu_torch.calibration import distortion_lines as dl
from alicevision_tpu_torch.calibration import zhang as zh
from alicevision_tpu_torch.camera import convert as cv
from alicevision_tpu_torch.camera import undistortion as und
from alicevision_tpu_torch.numeric import eigh64
from alicevision_tpu_torch.utils import calibration_scenes as cs

torch.set_num_threads(1)

KINDS = [und.UNDIST_RADIALK3, und.UNDIST_3DEANAMORPHIC4, und.UNDIST_3DECLASSICLD, und.UNDIST_3DERADIAL4]


def _params_for(kind, seed=0):
    """tests/test_undistortion.py's parameters of each model."""
    rng = np.random.RandomState(seed)
    p = und.default_params(kind)
    if kind == und.UNDIST_RADIALK3:
        p[:3] = [-0.08, 0.02, -0.004]
    elif kind == und.UNDIST_3DEANAMORPHIC4:
        p[:10] = 0.03 * rng.randn(10)
        p[10:13] = [0.05, 1.02, 0.98]
    elif kind == und.UNDIST_3DECLASSICLD:
        p[:5] = [-0.06, 1.1, 0.01, -0.02, 0.008]
    elif kind == und.UNDIST_3DERADIAL4:
        p[:8] = [-0.07, 0.004, -0.003, 0.01, 0.001, -0.002, 0.3, 0.05]
    return p


def t32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_undistortion_warp_and_inverse_match(kind):
    pts = np.random.RandomState(2).uniform(-0.6, 0.6, (40, 2)).astype(np.float32)
    params = _params_for(kind)
    fwd = und.undistort_normalized(kind, params, 1.2, t32(pts)).numpy()
    np.testing.assert_allclose(fwd, np.asarray(jund.undistort_normalized(kind, params, 1.2, pts)), atol=1e-6)
    back = und.inverse_normalized(kind, params, 1.2, t32(fwd), iters=25).numpy()
    np.testing.assert_allclose(back, np.asarray(jund.inverse_normalized(kind, params, 1.2, fwd, iters=25)), atol=1e-5)
    np.testing.assert_allclose(back, pts, atol=2e-5)


def test_undistortion_pixels_image_and_extra_match():
    u = und.Undistortion.make(und.UNDIST_RADIALK3, 2000, 1000, [-0.1, 0.0, 0.0], offset=(7.0, -3.0),
                              pixel_aspect_ratio=2.0)
    ju = jund.Undistortion.make(jund.UNDIST_RADIALK3, 2000, 1000, [-0.1, 0.0, 0.0], offset=(7.0, -3.0),
                                pixel_aspect_ratio=2.0)
    pix = np.random.RandomState(4).uniform([0, 0], [2000, 1000], (20, 2)).astype(np.float32)
    fwd = und.undistort_pixels(u, pix, device="cpu").numpy()
    np.testing.assert_allclose(fwd, np.asarray(jund.undistort_pixels(ju, pix)), atol=1e-3)
    np.testing.assert_allclose(und.inverse_pixels(u, fwd, iters=25, device="cpu").numpy(),
                               np.asarray(jund.inverse_pixels(ju, fwd, iters=25)), atol=1e-3)
    assert und.to_extra(u) == jund.to_extra(ju)
    back = und.from_extra({"undistortion": und.to_extra(u)}, 2000, 1000)
    assert back.kind == u.kind and np.allclose(back.params, u.params)
    # a plate of vertical stripes, distorted, then resampled (test_undistortion's)
    w, h = 160, 120
    u = und.Undistortion.make(und.UNDIST_RADIALK3, w, h, [-0.15, 0.0, 0.0])
    ju = jund.Undistortion.make(jund.UNDIST_RADIALK3, w, h, [-0.15, 0.0, 0.0])
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    src = np.asarray(jund.undistort_pixels(ju, np.stack([xx, yy], -1).reshape(-1, 2).astype(np.float32)))
    plate = (np.sin(src.reshape(h, w, 2)[..., 0] * 0.5) > 0).astype(np.float32)
    got = und.undistort_image(u, t32(plate)).numpy()
    want = np.asarray(jund.undistort_image(ju, jnp.asarray(plate)))
    assert np.mean(np.abs(got - want) > 1e-3) < 1e-3


@pytest.mark.parametrize("target", [cam.DISTO_BROWN, cam.DISTO_RADIALK1, cam.DISTO_FISHEYE])
def test_fit_distortion_matches(target):
    row = cam.make_intrinsics(640, 480, 500.0, disto_kind=cam.DISTO_RADIALK3, disto_params=(-0.2, 0.03, -0.002))
    jrow = jcam.make_intrinsics(640, 480, 500.0, disto_kind=jcam.DISTO_RADIALK3, disto_params=(-0.2, 0.03, -0.002))
    got = cv.fit_distortion(row, target)
    want = np.asarray(jcv.fit_distortion(jrow, target))
    np.testing.assert_allclose(got, want, atol=1e-4)
    for fn, jfn in ((cv.undistort_stmap, jcv.undistort_stmap), (cv.distort_stmap, jcv.distort_stmap)):
        np.testing.assert_allclose(fn(row, hw=(60, 80)), jfn(jrow, hw=(60, 80)), atol=2e-6)


def _render_board(rows, cols, H=360, W=480, Hmat=None, k1=0.0, noise=0.0, shade=0.0, square=36, seed=0):
    """tests/test_calibration.py::_render_board (homography warp, a
    display-side radial term, a brightness gradient, noise)."""
    rng = np.random.RandomState(seed)
    bh, bw = (rows + 1) * square, (cols + 1) * square
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    ox, oy = (W - bw) / 2, (H - bh) / 2
    x, y = xx, yy
    if k1 != 0.0:
        cx, cy = W / 2, H / 2
        s = 1.0 + k1 * ((x - cx) ** 2 + (y - cy) ** 2) / (0.5 * min(H, W)) ** 2
        x, y = cx + (x - cx) * s, cy + (y - cy) * s
    if Hmat is not None:
        Hi = np.linalg.inv(Hmat)
        w = Hi[2, 0] * x + Hi[2, 1] * y + Hi[2, 2]
        x, y = (Hi[0, 0] * x + Hi[0, 1] * y + Hi[0, 2]) / w, (Hi[1, 0] * x + Hi[1, 1] * y + Hi[1, 2]) / w
    bx, by = np.floor((x - ox) / square).astype(np.int64), np.floor((y - oy) / square).astype(np.int64)
    inside = (x >= ox) & (x < ox + bw) & (y >= oy) & (y < oy + bh)
    img = np.where(inside, np.where(((bx + by) % 2) == 0, 1.0, 0.25), 0.6)
    if shade:
        img = img * (1.0 - shade * xx / W)
    if noise:
        img = img + rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


BOARDS = {
    "perspective": dict(rows=5, cols=7, Hmat=np.array([[0.95, 0.12, 12.0], [-0.08, 0.9, 18.0], [2.0e-4, 3.5e-4, 1.0]]),
                        noise=0.01),
    "distorted": dict(rows=5, cols=7, k1=-0.12, noise=0.03, shade=0.35, seed=2),
}


@pytest.mark.parametrize("case", ["perspective", "distorted", "shoot"])
def test_checkerboard_matches(case):
    if case == "shoot":
        sh = cs.render_board_shoot(n_frames=3, rows=6, cols=9, wh=(640, 360), focal_px=500.0)
        img, rows, cols = sh["images"][1], 6, 9
    else:
        kw = BOARDS[case]
        img, rows, cols = _render_board(**kw), kw["rows"], kw["cols"]
    resp = cb.xcorner_response(t32(img)).numpy()
    want_resp = np.asarray(jcb.xcorner_response(jnp.asarray(img)))
    np.testing.assert_allclose(resp, want_resp, atol=1e-4 * np.abs(want_resp).max())
    got = cb.detect_checkerboard(img, rows, cols, device="cpu")
    want = jcb.detect_checkerboard(jnp.asarray(img), rows, cols)
    assert got is not None and want is not None
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-3)


def _zhang_views(distorted: bool):
    """tests/test_calibration.py's synthetic views (noisy, or with k1)."""
    from alicevision_tpu_torch.geometry.rotations import so3_exp

    K = np.array([[280.0 if distorted else 300.0, 0, 160.0], [0, 280.0 if distorted else 300.0, 120.0], [0, 0, 1.0]])
    obj = np.array([[i, j] for j in range(5) for i in range(7)], float)
    rng = np.random.RandomState(1 if distorted else 0)
    views = []
    for v in range(8 if distorted else 6):
        w = np.array([0.35, -0.25, 0.15]) * (v - 3.5) / 3.5 if distorted else \
            np.array([0.3, -0.2, 0.1]) * (v - 2.5) / 2.5
        R = so3_exp(torch.as_tensor(w + rng.randn(3) * 0.05)).numpy()
        t = np.array([-3.0 + v * 0.25, -2.0 + 0.1 * v, 11.0 + v * 0.4]) if distorted else \
            np.array([-3.0 + v * 0.3, -2.0, 12.0 + v * 0.5])
        Xc = np.stack([o[0] * R[:, 0] + o[1] * R[:, 1] + t for o in obj])
        p = Xc[:, :2] / Xc[:, 2:]
        if distorted:
            p = p * (1 - 0.15 * (p * p).sum(-1, keepdims=True))
        uv = p @ K[:2, :2].T + K[:2, 2]
        views.append(uv if distorted else uv + rng.randn(len(obj), 2) * 0.1)
    return obj, np.stack(views)


@pytest.mark.parametrize("distorted", [False, True])
def test_calibrate_zhang_matches(distorted):
    obj, views = _zhang_views(distorted)
    Hs = zh.homography_dlt_planar(t32(obj).expand(len(views), -1, -1), t32(views))
    jHs = jnp.stack([jzh.homography_dlt_planar(jnp.asarray(obj, jnp.float32), jnp.asarray(v, jnp.float32))
                     for v in views])
    np.testing.assert_allclose(Hs.numpy() / Hs.numpy()[:, 2:, 2:], np.asarray(jHs) / np.asarray(jHs)[:, 2:, 2:],
                               rtol=1e-3, atol=1e-3)
    K0 = zh.intrinsics_from_homographies(t32(np.asarray(jHs)))
    jK0 = jzh.intrinsics_from_homographies(jHs)
    np.testing.assert_allclose(K0.numpy(), np.asarray(jK0), rtol=1e-3, atol=1e-2)
    R, t = zh.pose_from_homography(t32(np.asarray(jK0)), t32(np.asarray(jHs)))
    for v in range(len(views)):
        jR, jt = jzh.pose_from_homography(jK0, jHs[v])
        np.testing.assert_allclose(R[v].numpy(), np.asarray(jR), atol=1e-4)
        np.testing.assert_allclose(t[v].numpy(), np.asarray(jt), rtol=1e-4, atol=1e-4)
    got = zh.calibrate_zhang(obj, views, refine_iters=30 if distorted else 20, device="cpu")
    want = jzh.calibrate_zhang(obj, views, refine_iters=30 if distorted else 20)
    np.testing.assert_allclose(got["K"], want["K"], rtol=1e-4)
    np.testing.assert_allclose(got["dist"], want["dist"], atol=1e-4)
    assert abs(got["rms"] - want["rms"]) < 1e-3


def test_distortion_from_lines_matches():
    """tests/test_merge_distortion_sphere.py's lines, bent by a known k."""
    jintr = jcam.make_intrinsics(640, 480, 500.0)
    gt = jintr._replace(disto_kind=jnp.asarray(jcam.DISTO_RADIALK3),
                        disto=jnp.zeros(jcam.DISTO_PARAMS).at[:3].set(jnp.asarray((-0.18, 0.03, 0.0))))
    ts = np.linspace(60, 580, 24)
    lines = [np.stack([ts, np.full_like(ts, y)], -1) for y in np.linspace(60, 420, 7)]
    lines += [np.stack([np.full(24, x), np.linspace(40, 440, 24)], -1) for x in np.linspace(80, 560, 7)]
    p = jcam.ima2cam(gt, jnp.asarray(np.stack(lines), jnp.float32))
    pts = np.asarray(jcam.cam2ima(gt, jcam.add_distortion(gt.disto_kind, gt.disto, p)))
    mask = np.ones(pts.shape[:2], bool)
    want, r0, r1 = jdl.calibrate_distortion_from_lines(jnp.asarray(pts), jnp.asarray(mask), jintr)
    got, g0, g1 = dl.calibrate_distortion_from_lines(pts, mask, cam.make_intrinsics(640, 480, 500.0), device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert abs(g0 - r0) < 1e-4 * r0 and g1 < r0 * 0.05 and abs(g1 - r1) < 1e-3


def test_undistortion_from_lines_matches():
    """tests/test_undistortion.py's 3DEClassicLD lines."""
    w, h = 1600, 1200
    true = und.Undistortion.make(und.UNDIST_3DECLASSICLD, w, h)
    tp = true.params.copy()
    tp[0], tp[4] = -0.05, 0.01
    jtrue = jund.Undistortion.make(jund.UNDIST_3DECLASSICLD, w, h)._replace(params=tp)
    rng = np.random.RandomState(5)
    lines = []
    for g in range(14):
        if g % 2 == 0:
            lines.append(np.stack([np.linspace(0.05 * w, 0.95 * w, 24), np.full(24, rng.uniform(0.1 * h, 0.9 * h))], -1))
        else:
            lines.append(np.stack([np.full(24, rng.uniform(0.1 * w, 0.9 * w)), np.linspace(0.05 * h, 0.95 * h, 24)], -1))
    pts = np.asarray(jund.inverse_pixels(jtrue, np.stack(lines).reshape(-1, 2), iters=30)).reshape(14, 24, 2)
    mask = np.ones((14, 24), bool)
    init = und.Undistortion.make(und.UNDIST_3DECLASSICLD, w, h)
    jinit = jund.Undistortion.make(jund.UNDIST_3DECLASSICLD, w, h)
    want, r0, r1 = jdl.calibrate_undistortion_from_lines(pts, mask, jinit, free_idx=[0, 4], iters=50)
    got, g0, g1 = dl.calibrate_undistortion_from_lines(pts, mask, init, free_idx=[0, 4], iters=50, device="cpu")
    np.testing.assert_allclose(got.params[[0, 4]], np.asarray(want.params)[[0, 4]], atol=1e-4)
    assert abs(g0 - r0) < 1e-4 * r0 and g1 < 0.05 and abs(g1 - r1) < 5e-3


def test_eigh64_keeps_the_null_vector_of_a_wide_spectrum():
    """Zhang's B-matrix normal equations span ~1e8: eigh64 returns the
    input's dtype and the float64 decomposition's smallest eigenvector."""
    rng = np.random.RandomState(0)
    A = rng.randn(64, 6) * np.array([1e-6, 1e-5, 1e-4, 1e-2, 1.0, 1.0])
    M = t32(A.T @ A)
    w, V = eigh64(M)
    assert w.dtype == V.dtype == torch.float32
    _, V64 = np.linalg.eigh(M.double().numpy())
    assert abs(abs(float(V[:, 0].double() @ torch.as_tensor(V64[:, 0]))) - 1.0) < 1e-6
