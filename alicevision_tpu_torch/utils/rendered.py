"""Rendered ground-truth fixtures: a box-world with real occlusion.

Host numpy copy of the MVS half of `alicevision_tpu/utils/rendered.py`: an
analytic world of axis-aligned boxes ray-cast per pixel, giving
procedural-texture images and exact depth maps (`render_views`) plus
surface points (`sample_surface_points`) to seed an SfM structure with.
`chip_smoke.py` and the port's tests build their posed scenes from it.

ref: src/aliceVision/multiview/NViewDataSet.hpp:21-74 (synthetic fixture
strategy), software/utils/main_qualityEvaluation.cpp (GT evaluation).
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-9


def default_boxes() -> np.ndarray:
    """(N, 2, 3) axis-aligned boxes (lo, hi corners) around the origin."""
    return np.array(
        [
            [[-1.6, -1.1, -1.0], [-0.3, 0.4, 0.6]],
            [[0.2, -1.3, -1.0], [1.5, 0.1, 0.2]],
            [[-0.5, 0.5, -1.0], [0.9, 1.6, 1.0]],
            [[-2.2, -2.2, -1.3], [2.2, 2.2, -1.0]],  # ground slab
        ]
    )


def _ray_box_t(o, d, boxes):
    """Nearest positive hit parameter of rays (..., 3) against each box.

    Returns t (..., N) with +inf where a ray misses that box."""
    o = o[..., None, :]  # (..., 1, 3)
    d = d[..., None, :]
    dsafe = np.where(np.abs(d) < _EPS, _EPS, d)
    t1 = (boxes[:, 0] - o) / dsafe  # (..., N, 3)
    t2 = (boxes[:, 1] - o) / dsafe
    tnear = np.minimum(t1, t2).max(axis=-1)
    tfar = np.maximum(t1, t2).min(axis=-1)
    hit = (tnear <= tfar) & (tfar > _EPS)
    t = np.where(tnear > _EPS, tnear, tfar)  # inside-the-box rays exit
    return np.where(hit, t, np.inf)


def _texture(p):
    """Procedural luminance in [0, 1] with energy at ZNCC window scales."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    v = (
        0.5
        + 0.17 * np.sin(9.7 * x + 1.3) * np.sin(7.9 * y + 0.7)
        + 0.13 * np.sin(12.3 * y + 2.1) * np.sin(10.1 * z + 1.9)
        + 0.12 * np.sin(11.1 * z + 0.3) * np.sin(8.7 * x + 2.7)
        + 0.08 * np.sin(23.0 * (x + y + z))
    )
    return np.clip(v, 0.0, 1.0)


def sample_surface_points(n, boxes=None, seed=0):
    """Points uniformly on the exposed faces of the box world."""
    if boxes is None:
        boxes = default_boxes()
    rng = np.random.RandomState(seed)
    N = len(boxes)
    ext = boxes[:, 1] - boxes[:, 0]
    # face areas per box: two faces per axis
    areas = np.stack(
        [
            ext[:, 1] * ext[:, 2],
            ext[:, 1] * ext[:, 2],
            ext[:, 0] * ext[:, 2],
            ext[:, 0] * ext[:, 2],
            ext[:, 0] * ext[:, 1],
            ext[:, 0] * ext[:, 1],
        ],
        axis=-1,
    ).reshape(-1)
    prob = areas / areas.sum()
    face = rng.choice(6 * N, size=n, p=prob)
    box = face // 6
    axis = (face % 6) // 2
    side = face % 2
    # two draws the reference makes and discards; kept so that one seed
    # gives the same points in both packages
    rng.rand(n)
    rng.rand(n)
    pts = np.empty((n, 3))
    for i in range(n):
        b, a, s = box[i], axis[i], side[i]
        lo, hi = boxes[b, 0], boxes[b, 1]
        p = lo + (hi - lo) * rng.rand(3)
        p[a] = hi[a] if s else lo[a]
        pts[i] = p
    # nudge off the surface along the outward normal so the point itself
    # does not occlude its own ray
    for i in range(n):
        nvec = np.zeros(3)
        nvec[axis[i]] = 1.0 if side[i] else -1.0
        pts[i] += 1e-4 * nvec
    return pts


def render_views(
    n_views: int = 6,
    wh=(320, 240),
    radius: float = 6.0,
    focal_px: float = 300.0,
    arc: float = 0.5,
    seed: int = 0,
):
    """Ray-cast images + exact depth maps of the box world.

    Cameras sit on a short arc (stereo-friendly baselines). Returns
    (images (V, H, W), depths (V, H, W), K (3,3), R (V,3,3), c (V,3));
    depth 0 where no surface is hit. Pixel (x, y) holds the ray through
    (x + 0.5, y + 0.5) of K."""
    boxes = default_boxes()
    rng = np.random.RandomState(seed)
    ang = np.linspace(-arc / 2, arc / 2, n_views) + rng.uniform(
        -0.005, 0.005, n_views
    )
    centers = np.stack(
        [radius * np.sin(ang), -radius * np.cos(ang), 0.3 * np.ones_like(ang)],
        axis=-1,
    )
    fwd = -centers / np.linalg.norm(centers, axis=-1, keepdims=True)
    up = np.broadcast_to(np.array([0.0, 0.0, 1.0]), fwd.shape)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=-2)
    w, h = wh
    K = np.array(
        [[focal_px, 0, w / 2.0], [0, focal_px, h / 2.0], [0, 0, 1.0]]
    )

    ys, xs = np.mgrid[0:h, 0:w]
    pix = np.stack(
        [(xs + 0.5 - K[0, 2]) / K[0, 0], (ys + 0.5 - K[1, 2]) / K[1, 1],
         np.ones_like(xs, np.float64)],
        axis=-1,
    )  # (H, W, 3) cam-frame directions
    imgs = np.zeros((n_views, h, w), np.float32)
    depths = np.zeros((n_views, h, w), np.float32)
    for v in range(n_views):
        dirs = pix @ R[v]  # rows of R are cam axes -> world dirs
        o = np.broadcast_to(centers[v], dirs.shape)
        t = _ray_box_t(o, dirs, boxes).min(axis=-1)
        hit = np.isfinite(t)
        p = o + np.where(hit, t, 0.0)[..., None] * dirs
        imgs[v] = np.where(hit, _texture(p), 0.5).astype(np.float32)
        # pix has z = 1 in the camera frame, so the ray parameter t is the
        # fronto-parallel depth
        depths[v] = np.where(hit, t, 0.0).astype(np.float32)
    return imgs, depths, K, R, centers
