"""Rendered inputs of the calibration, colour-chart and photometric-stereo
tools, on the host in numpy from a seed: what a calibration user shoots.

- `render_board_shoot`: a planar checkerboard seen by a pinhole camera with
  Zhang's radial distortion (x_d = x_u (1 + k1 r_u²) in normalized
  coordinates) under varied poses, with a brightness gradient and noise
  (the shading and noise of `tests/test_calibration.py::_render_board`).
- `render_chart`: the 24-patch Macbeth chart of
  `tests/test_color_checker.py::_render_chart` under a gain and an offset,
  centred on a dark frame.
- `render_photometric`: a glossy calibration sphere, and a textured
  Lambertian relief, each under the same directional lights seen by an
  orthographic camera (the sphere of `tests/test_cli_ext3.py::
  test_lighting_calibration_sphere`, the shading of its photometric test).
"""

from __future__ import annotations

import numpy as np

from ..misc.color_checker import MACBETH_SRGB


def look_at_board(centre_cam: np.ndarray, target: np.ndarray, roll: float = 0.0):
    """World->camera (R, t) of a camera at `centre_cam` (board frame, the
    board in z = 0 seen from z < 0) looking at `target`, rolled by `roll`."""
    fwd = target - centre_cam
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    cr, sr = np.cos(roll), np.sin(roll)
    R = np.stack([cr * right + sr * down, -sr * right + cr * down, fwd])
    return R, -R @ centre_cam


def board_poses(n: int, rows: int, cols: int, square: float, seed: int = 0):
    """n camera poses around a board of rows x cols inner corners: 1.3 to
    1.7 board widths away, up to ~45 deg off its normal, rolled up to 20 deg."""
    rng = np.random.RandomState(seed)
    centre = np.array([(cols - 1) * square / 2, (rows - 1) * square / 2, 0.0])
    width = (cols + 1) * square
    out = []
    for k in range(n):
        az = np.radians(-40 + 80 * k / max(n - 1, 1) + rng.uniform(-5, 5))
        el = np.radians(rng.uniform(-25, 25))
        d = width * rng.uniform(1.3, 1.7)
        cam = centre + d * np.array([np.sin(az) * np.cos(el), np.sin(el), -np.cos(az) * np.cos(el)])
        target = centre + rng.uniform(-0.1, 0.1, 3) * width * np.array([1, 1, 0])
        out.append(look_at_board(cam, target, np.radians(rng.uniform(-20, 20))))
    return out


def _undistort_k1(xd: np.ndarray, yd: np.ndarray, k1: float, iters: int = 30):
    """x_u with x_u (1 + k1 |x_u|²) = x_d, by fixed-point steps."""
    xu, yu = xd.copy(), yd.copy()
    for _ in range(iters):
        s = 1.0 + k1 * (xu * xu + yu * yu)
        xu, yu = xd / s, yd / s
    return xu, yu


def render_board_shoot(n_frames: int = 15, rows: int = 6, cols: int = 9, wh=(1920, 1080), focal_px: float = 1500.0,
                       k1: float = -0.12, square: float = 1.0, shade: float = 0.3, noise: float = 0.02,
                       seed: int = 0) -> dict:
    """n_frames views of a board of rows x cols inner corners (rows + 1 by
    cols + 1 squares on a light margin). Returns the images (F, H, W)
    float32, K (3, 3), k1, the poses (R (F, 3, 3), t (F, 3)) and each
    frame's true corners (F, rows*cols, 2), row-major as
    `detect_checkerboard` orders them (up to the grid's symmetries)."""
    w, h = wh
    K = np.array([[focal_px, 0.0, w / 2.0], [0.0, focal_px, h / 2.0], [0.0, 0.0, 1.0]])
    rng = np.random.RandomState(seed + 1)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xu, yu = _undistort_k1((xs - K[0, 2]) / focal_px, (ys - K[1, 2]) / focal_px, k1)
    obj = square * np.array([[i, j, 0.0] for j in range(rows) for i in range(cols)])
    imgs, corners, Rs, ts = [], [], [], []
    for R, t in board_poses(n_frames, rows, cols, square, seed):
        # the ray of each pixel meets the board plane z = 0 at board (u, v)
        cb = -R.T @ t
        d = np.stack([xu, yu, np.ones_like(xu)], -1) @ R
        tt = -cb[2] / np.where(np.abs(d[..., 2]) < 1e-12, 1e-12, d[..., 2])
        u = (cb[0] + tt * d[..., 0]) / square
        v = (cb[1] + tt * d[..., 1]) / square
        board = (u >= -1) & (u < cols) & (v >= -1) & (v < rows) & (tt > 0)
        margin = (u >= -1.6) & (u < cols + 0.6) & (v >= -1.6) & (v < rows + 0.6) & (tt > 0)
        img = np.where(board & ((np.floor(u) + np.floor(v)) % 2 == 0), 0.9, 0.15)
        img = np.where(board, img, np.where(margin, 0.9, 0.45))
        img = img * (1.0 - shade * xs / w) + rng.normal(0.0, noise, img.shape)
        imgs.append(np.clip(img, 0, 1).astype(np.float32))
        Xc = obj @ R.T + t
        p = Xc[:, :2] / Xc[:, 2:]
        p = p * (1.0 + k1 * (p * p).sum(-1, keepdims=True))
        corners.append(p * focal_px + K[:2, 2])
        Rs.append(R)
        ts.append(t)
    return dict(images=np.stack(imgs), K=K, k1=k1, R=np.stack(Rs), t=np.stack(ts), corners=np.stack(corners),
                rows=rows, cols=cols, square=square, wh=tuple(wh))


def corner_errors(det: np.ndarray, gt: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Per-corner distances of a detected grid (rows*cols, 2) to the truth
    under the best of the grid's symmetries (the detector's orientation is
    its own)."""
    d = det.reshape(rows, cols, 2)
    g = gt.reshape(rows, cols, 2)
    cands = [d, d[::-1], d[:, ::-1], d[::-1, ::-1]]
    errs = [np.linalg.norm(c - g, axis=-1).reshape(-1) for c in cands]
    return min(errs, key=lambda e: e.mean())


def render_chart(wh=(1920, 1080), patch: int = 120, gap: int = 26, gain: float = 0.8, offset: float = 0.05,
                 noise: float = 0.01, seed: int = 0):
    """The 24-patch chart (4 x 6, row-major) under colour = gain * sRGB +
    offset, centred on a near-black frame, with noise. Returns (image (H, W,
    3) float32 in [0, 1], patch centres (24, 2))."""
    rows, cols = 4, 6
    w, h = wh
    rng = np.random.RandomState(seed)
    img = np.full((h, w, 3), 0.02, np.float32)
    cw, ch = cols * patch + (cols - 1) * gap, rows * patch + (rows - 1) * gap
    x00, y00 = (w - cw) // 2, (h - ch) // 2
    centers = []
    for r in range(rows):
        for c in range(cols):
            y0, x0 = y00 + r * (patch + gap), x00 + c * (patch + gap)
            img[y0:y0 + patch, x0:x0 + patch] = np.clip(MACBETH_SRGB[r * cols + c] * gain + offset, 0, 1)
            centers.append([x0 + patch / 2, y0 + patch / 2])
    img = img + rng.randn(h, w, 3).astype(np.float32) * noise
    return np.clip(img, 0, 1).astype(np.float32), np.array(centers)


def photometric_lights(n: int = 12, max_deg: float = 35.0, seed: int = 0) -> np.ndarray:
    """n unit light directions (towards the light, z < 0: the camera looks
    down +z) on two rings up to max_deg off the viewing axis."""
    rng = np.random.RandomState(seed)
    out = []
    for k in range(n):
        tilt = np.radians(max_deg * (0.55 if k % 2 else 1.0))
        az = 2 * np.pi * k / n + rng.uniform(-0.1, 0.1)
        out.append([np.sin(tilt) * np.cos(az), np.sin(tilt) * np.sin(az), -np.cos(tilt)])
    return np.array(out)


def relief(wh, seed: int = 0):
    """A smooth relief z(x, y) in pixels over the frame (Gaussian bumps on a
    slope, slopes below ~0.5) and its unit normals (H, W, 3), n_z < 0."""
    w, h = wh
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    z = 0.05 * xs + 0.03 * ys
    zx, zy = np.full_like(z, 0.05), np.full_like(z, 0.03)
    for _ in range(6):
        cx, cy = rng.uniform(0.15, 0.85) * w, rng.uniform(0.15, 0.85) * h
        s = rng.uniform(0.06, 0.12) * w
        a = rng.uniform(-0.25, 0.25) * s
        g = a * np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * s * s))
        z += g
        zx += -g * (xs - cx) / (s * s)
        zy += -g * (ys - cy) / (s * s)
    n = np.stack([zx, zy, -np.ones_like(z)], -1)
    return z, n / np.linalg.norm(n, axis=-1, keepdims=True)


def render_photometric(wh=(2048, 1536), n_lights: int = 12, sphere_r: float = 300.0, noise: float = 0.005,
                       seed: int = 0) -> dict:
    """The photometric shoot under `photometric_lights`: a glossy sphere of
    radius sphere_r px (ambient 0.3, diffuse 0.2, a Phong highlight of
    exponent 80 and weight 0.45) on a black ground (images "sphere", (L, H,
    W)), and a textured Lambertian
    relief filling the frame (albedo 0.35-0.95, images "object"), float32
    with noise. Returns the images, the lights, the sphere (cx, cy, r), the
    relief's depth, normals and albedo."""
    w, h = wh
    rng = np.random.RandomState(seed)
    L = photometric_lights(n_lights, seed=seed)
    cx, cy = 0.55 * w, 0.48 * h
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    nx, ny = (xs - cx) / sphere_r, (ys - cy) / sphere_r
    inside = nx * nx + ny * ny < 1.0
    ns = np.stack([nx, ny, -np.sqrt(np.clip(1 - nx * nx - ny * ny, 0, 1))], -1)
    view = np.array([0.0, 0.0, -1.0])
    z, n = relief(wh, seed)
    tex = 0.65 + 0.3 * np.sin(xs / 37.0) * np.cos(ys / 23.0)
    albedo = np.clip(tex + 0.05 * rng.standard_normal((h, w)), 0.35, 0.95)
    sphere, obj = [], []
    for ld in L:
        hv = (ld + view) / np.linalg.norm(ld + view)
        spec = np.clip(ns @ hv, 0, 1) ** 80
        img = np.where(inside, 0.3 + 0.2 * np.clip(ns @ ld, 0, None) + 0.45 * spec, 0.0)
        sphere.append(np.clip(img + rng.normal(0, noise, img.shape), 0, 1).astype(np.float32))
        shade = albedo * np.clip(n @ ld, 0, None)
        obj.append((shade + rng.normal(0, noise, shade.shape)).astype(np.float32))
    return dict(sphere=np.stack(sphere), object=np.stack(obj), lights=L, sphere_cxr=(cx, cy, sphere_r), depth=z,
                normals=n, albedo=albedo, wh=tuple(wh))
