"""Rendered ground-truth fixtures: a box-world with real occlusion.

Port of `alicevision_tpu/utils/rendered.py`: an analytic world of
axis-aligned boxes ray-cast per pixel, giving

  * `render_views` — procedural-texture images and exact depth maps for the
    MVS stack, plus surface points (`sample_surface_points`) to seed an SfM
    structure with;
  * `hard_scene` — the 40-view SfM fixture with radial K3 distortion,
    observation noise and true occlusion, and `verified_matches_from_scene`,
    its epipolar-verified matches with outliers;
  * `render_hard_views` — the same ring rendered as distorted images for the
    real front end. It ray-casts in float64 torch on `device`;
    `render_hard_views_numpy` is its plain host version.

Everything else is host numpy, copied from the reference so that the same
seeds give the same arrays. `chip_smoke.py` and the port's tests build
their scenes from it.

ref: src/aliceVision/multiview/NViewDataSet.hpp:21-74 (synthetic fixture
strategy), software/utils/main_qualityEvaluation.cpp (GT evaluation).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device

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


_NOISE_GRIDS: dict = {}


def _noise_grid(seed: int, size: int = 64) -> np.ndarray:
    key = (seed, size)
    if key not in _NOISE_GRIDS:
        _NOISE_GRIDS[key] = (
            np.random.RandomState(seed).rand(size, size, size).astype(np.float32)
        )
    return _NOISE_GRIDS[key]


# octaves of the feature texture: (cells per world unit, amplitude)
_RICH_OCTAVES = [(3.0 * (2.0**o), 1.0 / (1.6**o)) for o in range(5)]


def _texture_rich(p, seed: int = 11):
    """Multi-octave 3D value-noise texture for FEATURE pipelines.

    The base `_texture` is tuned for ZNCC windows; SIFT descriptors on it
    are locally repetitive. Trilinear value noise of the WORLD point gives
    distinctive blobs at every scale, consistent across views."""
    g = _noise_grid(seed)
    size = g.shape[0]
    out = np.zeros(p.shape[:-1], np.float32)
    amp_sum = 0.0
    for freq, amp in _RICH_OCTAVES:
        q = np.mod(p * freq, size)
        q0 = np.floor(q).astype(np.int64)
        f = (q - q0).astype(np.float32)
        q1 = (q0 + 1) % size
        x0, y0, z0 = q0[..., 0], q0[..., 1], q0[..., 2]
        x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2]
        fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
        c00 = g[x0, y0, z0] * (1 - fx) + g[x1, y0, z0] * fx
        c10 = g[x0, y1, z0] * (1 - fx) + g[x1, y1, z0] * fx
        c01 = g[x0, y0, z1] * (1 - fx) + g[x1, y0, z1] * fx
        c11 = g[x0, y1, z1] * (1 - fx) + g[x1, y1, z1] * fx
        c0 = c00 * (1 - fy) + c10 * fy
        c1 = c01 * (1 - fy) + c11 * fy
        out += amp * (c0 * (1 - fz) + c1 * fz)
        amp_sum += amp
    out /= amp_sum
    # octave averaging concentrates values near 0.5 (image std 0.034, too
    # flat for the DoG contrast gate): expand around the mean
    return np.clip(0.5 + 3.0 * (out - 0.5), 0.02, 0.98)


def _ray_box_t_torch(o, d, boxes):
    """`_ray_box_t` on tensors: o, d (..., 3), boxes (N, 2, 3) of one dtype
    and device; t (..., N), +inf where a ray misses that box."""
    o = o[..., None, :]
    d = d[..., None, :]
    dsafe = torch.where(d.abs() < _EPS, torch.full_like(d, _EPS), d)
    t1 = (boxes[:, 0] - o) / dsafe
    t2 = (boxes[:, 1] - o) / dsafe
    tnear = torch.minimum(t1, t2).amax(dim=-1)
    tfar = torch.maximum(t1, t2).amin(dim=-1)
    hit = (tnear <= tfar) & (tfar > _EPS)
    t = torch.where(tnear > _EPS, tnear, tfar)
    return torch.where(hit, t, torch.full_like(t, torch.inf))


def _texture_rich_torch(p, grid):
    """`_texture_rich` on a float64 tensor of points (..., 3), with the
    noise grid as a float32 tensor on p's device: the cell index in float64
    as the host version takes it, the interpolation in float32."""
    size = grid.shape[0]
    flat = grid.reshape(-1)
    out = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    amp_sum = 0.0
    for freq, amp in _RICH_OCTAVES:
        q = torch.remainder(p * freq, size)
        q0f = torch.floor(q)
        f = (q - q0f).to(torch.float32)
        q0 = q0f.to(torch.int64)
        q1 = (q0 + 1) % size
        x0, y0, z0 = q0.unbind(-1)
        x1, y1, z1 = q1.unbind(-1)
        fx, fy, fz = f.unbind(-1)

        def g(x, y, z):
            return flat[(x * size + y) * size + z]

        c00 = g(x0, y0, z0) * (1 - fx) + g(x1, y0, z0) * fx
        c10 = g(x0, y1, z0) * (1 - fx) + g(x1, y1, z0) * fx
        c01 = g(x0, y0, z1) * (1 - fx) + g(x1, y0, z1) * fx
        c11 = g(x0, y1, z1) * (1 - fx) + g(x1, y1, z1) * fx
        c0 = c00 * (1 - fy) + c10 * fy
        c1 = c01 * (1 - fy) + c11 * fy
        out += amp * (c0 * (1 - fz) + c1 * fz)
        amp_sum += amp
    out /= amp_sum
    return torch.clamp(0.5 + 3.0 * (out - 0.5), 0.02, 0.98)


def _ring_cameras(n_views, radius, height_amp, focal_px, wh, seed):
    rng = np.random.RandomState(seed)
    ang = np.linspace(0, 2 * np.pi, n_views, endpoint=False)
    ang = ang + rng.uniform(-0.02, 0.02, n_views)
    z = height_amp * np.sin(2.1 * ang)
    centers = np.stack(
        [radius * np.cos(ang), radius * np.sin(ang), z], axis=-1
    )
    fwd = -centers / np.linalg.norm(centers, axis=-1, keepdims=True)
    up = np.broadcast_to(np.array([0.0, 0.0, 1.0]), fwd.shape)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=-2)  # world->cam rows
    w, h = wh
    K = np.array(
        [[focal_px, 0, w / 2.0], [0, focal_px, h / 2.0], [0, 0, 1.0]]
    )
    return K, R, centers


class HardScene(NamedTuple):
    K: np.ndarray  # (3, 3) shared pinhole
    disto: np.ndarray  # (3,) radial k1,k2,k3
    R: np.ndarray  # (V, 3, 3) world->cam
    c: np.ndarray  # (V, 3) centers
    points: np.ndarray  # (P, 3) surface points
    observations: np.ndarray  # (V, P, 2) DISTORTED noisy pixels
    visible: np.ndarray  # (V, P) occlusion-aware visibility
    image_size: tuple


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


def hard_scene(
    n_views: int = 40,
    n_points: int = 600,
    radius: float = 6.0,
    focal_px: float = 900.0,
    image_size=(1280, 960),
    disto=(-0.25, 0.06, -0.005),
    noise_px: float = 0.4,
    seed: int = 0,
) -> HardScene:
    """40-view occluded box-world with radial distortion + pixel noise."""
    boxes = default_boxes()
    K, R, c = _ring_cameras(n_views, radius, 1.2, focal_px, image_size, seed)
    pts = sample_surface_points(n_points, boxes, seed + 1)

    # occlusion: the segment camera->point must hit nothing first
    o = np.broadcast_to(c[:, None, :], (n_views, n_points, 3))
    d = pts[None, :, :] - c[:, None, :]
    t_hit = _ray_box_t(o, d, boxes).min(axis=-1)  # param along d (len ~1)
    unoccluded = t_hit > 1.0 - 1e-3

    x_cam = np.einsum("vij,vpj->vpi", R, pts[None] - c[:, None])
    z = x_cam[..., 2]
    in_front = z > 0.1
    xn = x_cam[..., :2] / np.where(in_front, z, 1.0)[..., None]
    # radial K3 distortion (camera/DistortionRadial.hpp K3 model)
    k1, k2, k3 = disto
    r2 = (xn**2).sum(-1)
    scale = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xn * scale[..., None]
    obs = xd * focal_px + np.array(image_size) / 2.0
    rng = np.random.RandomState(seed + 2)
    obs = obs + noise_px * rng.randn(*obs.shape)

    w, h = image_size
    visible = (
        in_front
        & unoccluded
        & (obs[..., 0] >= 0)
        & (obs[..., 0] < w)
        & (obs[..., 1] >= 0)
        & (obs[..., 1] < h)
    )
    return HardScene(
        K=K,
        disto=np.asarray(disto),
        R=R,
        c=c,
        points=pts,
        observations=obs,
        visible=visible,
        image_size=tuple(image_size),
    )


def undistort_radial_k3(xd, disto, iters: int = 12):
    """Invert the radial K3 model by fixed-point iteration (host numpy).

    xd: (..., 2) distorted normalized coords; returns undistorted xn with
    xn * (1 + r2 (k1 + r2 (k2 + r2 k3))) = xd (camera/DistortionRadial.hpp
    K3 semantics)."""
    k1, k2, k3 = disto
    xn = np.array(xd, np.float64, copy=True)
    for _ in range(iters):
        r2 = (xn**2).sum(-1)
        scale = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xn = xd / np.maximum(scale, 1e-6)[..., None]
    return xn


def _undistort_radial_k3_torch(xd, disto, iters: int = 12):
    """`undistort_radial_k3` on a float64 tensor, on its device."""
    k1, k2, k3 = (float(k) for k in disto)
    xn = xd
    for _ in range(iters):
        r2 = (xn**2).sum(-1)
        scale = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xn = xd / torch.clamp(scale, min=1e-6)[..., None]
    return xn


def render_hard_views(
    n_views: int = 40,
    wh=(1280, 960),
    radius: float = 6.0,
    focal_px: float = 900.0,
    disto=(-0.25, 0.06, -0.005),
    seed: int = 0,
    device="cuda",
):
    """Ray-cast DISTORTED images of the hard ring scene — the pixels a
    physical camera with radial-K3 distortion would record.

    Same camera ring as `hard_scene` (identical seed/params give identical
    GT poses); the front end must recover poses AND the distortion from
    these pixels (ref: sfm/pipeline/sequential/sequentialSfM_test.cpp,
    software/utils/main_qualityEvaluation.cpp). The rays, the box hits and
    the texture are evaluated in float64 torch on `device`, one view at a
    time; `render_hard_views_numpy` is the same function on the host.

    Returns host arrays (images (V, H, W) float32, K (3,3), disto (3,),
    R (V,3,3), c (V,3))."""
    dev = resolve_device(device)
    K, R, c = _ring_cameras(n_views, radius, 1.2, focal_px, wh, seed)
    w, h = wh
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=dev),
        torch.arange(w, dtype=torch.float64, device=dev),
        indexing="ij",
    )
    xd = torch.stack(
        [(xs + 0.5 - K[0, 2]) / K[0, 0], (ys + 0.5 - K[1, 2]) / K[1, 1]], dim=-1
    )  # distorted normalized coords of each pixel
    xn = _undistort_radial_k3_torch(xd, disto).reshape(-1, 2)
    dirs_cam = torch.cat([xn, torch.ones_like(xn[:, :1])], dim=-1)
    boxes = torch.as_tensor(default_boxes(), dtype=torch.float64, device=dev)
    grid = torch.as_tensor(_noise_grid(11), device=dev)
    R_t = torch.as_tensor(R, dtype=torch.float64, device=dev)
    c_t = torch.as_tensor(c, dtype=torch.float64, device=dev)
    imgs = torch.empty((n_views, h * w), dtype=torch.float32, device=dev)
    for v in range(n_views):
        dirs = dirs_cam @ R_t[v]  # rows of R are cam axes -> world dirs
        o = c_t[v].expand_as(dirs)
        t = _ray_box_t_torch(o, dirs, boxes).amin(dim=-1)
        hit = torch.isfinite(t)
        p = o + torch.where(hit, t, torch.zeros_like(t))[:, None] * dirs
        tex = _texture_rich_torch(p, grid)
        imgs[v] = torch.where(hit, tex, torch.full_like(tex, 0.5))
    return imgs.reshape(n_views, h, w).cpu().numpy(), K, np.asarray(disto), R, c


def render_hard_views_numpy(
    n_views: int = 40,
    wh=(1280, 960),
    radius: float = 6.0,
    focal_px: float = 900.0,
    disto=(-0.25, 0.06, -0.005),
    seed: int = 0,
    views=None,
):
    """`render_hard_views` in host numpy, the reference's own code: the
    plain version the torch renderer is held against. `views` renders only
    those views of the ring, in that order (all by default): a check of a
    full-size device render need not pay for all 40 on the host."""
    boxes = default_boxes()
    K, R, c = _ring_cameras(n_views, radius, 1.2, focal_px, wh, seed)
    w, h = wh
    ys, xs = np.mgrid[0:h, 0:w]
    xd = np.stack(
        [(xs + 0.5 - K[0, 2]) / K[0, 0], (ys + 0.5 - K[1, 2]) / K[1, 1]],
        axis=-1,
    )  # distorted normalized coords of each pixel
    xn = undistort_radial_k3(xd, disto)
    dirs_cam = np.concatenate([xn, np.ones_like(xn[..., :1])], axis=-1)
    views = range(n_views) if views is None else views
    imgs = np.zeros((len(views), h, w), np.float32)
    for i, v in enumerate(views):
        dirs = dirs_cam @ R[v]  # rows of R are cam axes -> world dirs
        o = np.broadcast_to(c[v], dirs.shape)
        t = _ray_box_t(o, dirs, boxes).min(axis=-1)
        hit = np.isfinite(t)
        p = o + np.where(hit, t, 0.0)[..., None] * dirs
        imgs[i] = np.where(hit, _texture_rich(p), 0.5).astype(np.float32)
    return imgs, K, np.asarray(disto), R, c


def verified_matches_from_scene(
    hs: HardScene,
    ring_window: int = 4,
    outlier_frac: float = 0.02,
    seed: int = 7,
    verify_px: float = 30.0,
):
    """Pairwise feature matches from co-visibility + wrong-match outliers,
    passed through an epipolar verification emulating featureMatching's
    geometric filter (the real pipeline never feeds raw putative matches to
    track building; epipolar-consistent outliers survive, exactly as they
    do for the reference). Returns (pair_matches, features_xy, n_feats)."""
    V, P = hs.visible.shape
    rng = np.random.RandomState(seed)
    feat_of = -np.ones((V, P), np.int64)
    features_xy = {}
    for v in range(V):
        vis = np.nonzero(hs.visible[v])[0]
        feat_of[v, vis] = np.arange(len(vis))
        features_xy[v] = hs.observations[v, vis].astype(np.float32)
    f_px = hs.K[0, 0]
    cx, cy = hs.K[0, 2], hs.K[1, 2]
    pair_matches = {}
    for i0 in range(V):
        for dj in range(1, ring_window + 1):
            # keep the ring CLOSED: wrap-around pairs (V-1, 0) etc. are
            # stored canonically as (min, max)
            j0 = (i0 + dj) % V
            i, j = min(i0, j0), max(i0, j0)
            if i == j or (i, j) in pair_matches:
                continue
            common = np.nonzero(hs.visible[i] & hs.visible[j])[0]
            if len(common) < 8:
                continue
            m = np.stack([feat_of[i, common], feat_of[j, common]], axis=1)
            n_out = int(outlier_frac * len(m))
            if n_out:
                rows = rng.choice(len(m), n_out, replace=False)
                m[rows, 1] = rng.randint(0, hs.visible[j].sum(), n_out)
            R_rel = hs.R[j] @ hs.R[i].T
            t_rel = hs.R[j] @ (hs.c[i] - hs.c[j])
            tx = np.array([
                [0, -t_rel[2], t_rel[1]],
                [t_rel[2], 0, -t_rel[0]],
                [-t_rel[1], t_rel[0], 0],
            ])
            E = tx @ R_rel
            uv_i = features_xy[i][m[:, 0]]
            uv_j = features_xy[j][m[:, 1]]
            x1 = np.column_stack([(uv_i - [cx, cy]) / f_px, np.ones(len(m))])
            x2 = np.column_stack([(uv_j - [cx, cy]) / f_px, np.ones(len(m))])
            Ex1 = x1 @ E.T
            x2tEx1 = np.sum(x2 * Ex1, axis=1)
            Etx2 = x2 @ E
            denom = (
                Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2
                + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
            )
            sampson = x2tEx1**2 / np.maximum(denom, 1e-12)
            keep = sampson < (verify_px / f_px) ** 2
            m = m[keep]
            if len(m) >= 8:
                pair_matches[(i, j)] = m
    n_feats = {v: int(hs.visible[v].sum()) for v in range(V)}
    return pair_matches, features_xy, n_feats
