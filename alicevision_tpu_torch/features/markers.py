"""Fiducial marker detection: AprilTag (tag16h5) and CCTag-style rings.

Host copy of `alicevision_tpu/features/markers.py` (numpy +
scipy.ndimage; the JAX package's `features/__init__` imports jax). The
counterpart of the reference's optional marker describers (ref: src/aliceVision/feature/imageDescriberCommon.hpp:19-50
lists CCTAG3/CCTAG4 and APRILTAG16H5 describer types; the reference
delegates to the external CCTag / apriltag libraries). Here both are
implemented from scratch:

  * AprilTag: adaptive threshold -> dark-quad extraction (connected
    components + hull-corner fitting, host-side scipy like the other
    irregular geometry) -> 4pt homography -> payload grid sampling ->
    rotation-invariant lookup in the tag16h5 family table. The family
    codes below are the real tag16h5 payloads (white=1 bits of the inner
    4x4 grid, row-major), so detections interoperate with physical tags.
  * CCTag-style: concentric-ring markers whose ID is encoded in ring
    radius ratios (the CCTag idea, Calvet et al. 2016). The radial
    gradient-symmetry vote finds centers; ring radii come from the
    angular-mean intensity profile. The 32-entry ratio bank is generated
    deterministically here (the upstream library's bank is proprietary
    data, not re-distributed).

Marker observations integrate with the matching stack as one-hot
"descriptors" (index = marker id), so exact-id matching falls out of the
standard top-1 descriptor matcher, mirroring how the reference stores
marker ids in Regions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy import ndimage

# tag16h5 payload codes: bit 15 = top-left cell, row-major, white=1.
# Extracted from the published tag16h5 marker images (30 tags, 4x4 inner
# grid inside a black border ring and white quiet zone).
TAG16H5_CODES = [
    0xD8C4, 0xA574, 0x562C, 0x9DA2, 0x659E, 0xD6FE, 0x1ACD, 0xA2E7,
    0x9A7F, 0xB6A8, 0xD01C, 0xD50F, 0x21B0, 0x6CE2, 0x4E31, 0x08F5,
    0x3C90, 0x2DC9, 0xC0A5, 0xF162, 0xEC87, 0xA9EA, 0x42FB, 0xB838,
    0x3B97, 0xB5CE, 0xFAB5, 0x0CAB, 0x53E0, 0x74F5,
]


class MarkerDetection(NamedTuple):
    marker_id: int
    center: np.ndarray  # (2,) pixel x, y
    corners: np.ndarray | None  # (4, 2) for quads, None for rings
    scale: float  # half side / outer radius in pixels


# ---------------------------------------------------------------------------
# AprilTag tag16h5
# ---------------------------------------------------------------------------


def _code_to_grid(code: int) -> np.ndarray:
    bits = [(code >> (15 - k)) & 1 for k in range(16)]
    return np.array(bits, np.uint8).reshape(4, 4)


def _grid_to_code(grid: np.ndarray) -> int:
    bits = grid.reshape(-1)
    return int(sum(int(b) << (15 - k) for k, b in enumerate(bits)))


_ROT_LUT = None


def _rotation_lut():
    """code -> (id, rotation) for all 4 rotations of every family entry."""
    global _ROT_LUT
    if _ROT_LUT is None:
        lut = {}
        for tid, code in enumerate(TAG16H5_CODES):
            g = _code_to_grid(code)
            for r in range(4):
                lut.setdefault(_grid_to_code(np.rot90(g, -r)), (tid, r))
        _ROT_LUT = lut
    return _ROT_LUT


def render_apriltag(marker_id: int, size: int = 96) -> np.ndarray:
    """Render a tag16h5 marker (float image in [0,1], incl. 1-cell white
    quiet zone + 1-cell black border, 8x8 cells total)."""
    grid = _code_to_grid(TAG16H5_CODES[marker_id])
    cells = np.ones((8, 8), np.float32)
    cells[1:7, 1:7] = 0.0  # black border ring
    cells[2:6, 2:6] = grid
    return np.kron(cells, np.ones((size // 8, size // 8), np.float32))


def _homography_4pt(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """DLT homography from 4 correspondences (src -> dst)."""
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        A.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    return Vt[-1].reshape(3, 3)


def _quad_corners(mask_pts: np.ndarray) -> np.ndarray | None:
    """Fit 4 corners to a dark blob: farthest-point hull heuristic."""
    if len(mask_pts) < 16:
        return None
    pts = mask_pts.astype(np.float64)
    c = pts.mean(0)
    p0 = pts[np.argmax(((pts - c) ** 2).sum(1))]
    p1 = pts[np.argmax(((pts - p0) ** 2).sum(1))]
    d = p1 - p0
    n = np.array([-d[1], d[0]]) / max(np.linalg.norm(d), 1e-9)
    side = (pts - p0) @ n
    p2 = pts[np.argmax(side)]
    p3 = pts[np.argmin(side)]
    quad = np.stack([p0, p2, p1, p3])
    # order counter-clockwise around centroid
    qc = quad.mean(0)
    ang = np.arctan2(quad[:, 1] - qc[1], quad[:, 0] - qc[0])
    quad = quad[np.argsort(ang)]
    # reject degenerate / extremely thin quads
    e = np.roll(quad, -1, 0) - quad
    lens = np.linalg.norm(e, axis=1)
    if lens.min() < 6 or lens.min() / lens.max() < 0.3:
        return None
    return quad


def detect_apriltags(
    img: np.ndarray,
    min_area: int = 100,
    max_hamming: int = 1,
) -> list[MarkerDetection]:
    """Detect tag16h5 markers in a grayscale image in [0,1]."""
    img = np.asarray(img, np.float32)
    local_mean = ndimage.uniform_filter(img, size=31)
    dark = img < local_mean - 0.1
    labels, n = ndimage.label(dark)
    out = []
    lut = _rotation_lut()
    for sl_idx, sl in enumerate(ndimage.find_objects(labels)):
        if sl is None:
            continue
        region = labels[sl] == (sl_idx + 1)
        if region.sum() < min_area:
            continue
        ys, xs = np.nonzero(region)
        pts = np.stack([xs + sl[1].start, ys + sl[0].start], 1)
        quad = _quad_corners(pts)
        if quad is None:
            continue
        # payload sampling: unit square (border incl.) -> quad.
        # corners bound the BLACK border = cells [1, 7) of 8.
        H = _homography_4pt(
            np.array([[0.0, 0], [1, 0], [1, 1], [0, 1]]), quad
        )
        gx, gy = np.meshgrid(
            (np.arange(6) + 0.5) / 6.0, (np.arange(6) + 0.5) / 6.0
        )
        p = np.stack([gx, gy, np.ones_like(gx)], -1) @ H.T
        u = p[..., 0] / p[..., 2]
        v = p[..., 1] / p[..., 2]
        Hh, Ww = img.shape
        ui = np.clip(np.round(u).astype(int), 0, Ww - 1)
        vi = np.clip(np.round(v).astype(int), 0, Hh - 1)
        samples = img[vi, ui]
        thresh = 0.5 * (samples.min() + samples.max())
        cells = (samples > thresh).astype(np.uint8)
        # border cells (outer ring of the 6x6) must be black
        border = np.concatenate(
            [cells[0], cells[-1], cells[1:-1, 0], cells[1:-1, -1]]
        )
        if border.mean() > 0.25:
            continue
        grid = cells[1:-1, 1:-1]
        code = _grid_to_code(grid)
        hit = lut.get(code)
        if hit is None and max_hamming > 0:
            best = None
            for cand, idrot in lut.items():
                h = bin(cand ^ code).count("1")
                if h <= max_hamming and (best is None or h < best[0]):
                    best = (h, idrot)
            hit = best[1] if best else None
        if hit is None:
            continue
        tid, _ = hit
        out.append(
            MarkerDetection(
                tid,
                quad.mean(0),
                quad,
                0.5 * float(np.linalg.norm(quad[0] - quad[2])) / np.sqrt(2),
            )
        )
    return out


# ---------------------------------------------------------------------------
# CCTag-style concentric ring markers
# ---------------------------------------------------------------------------

N_CCTAG_IDS = 32


def cctag_bank(n_ids: int = N_CCTAG_IDS) -> np.ndarray:
    """Deterministic 3-crown ratio bank: each marker has ring outer/inner
    edge radii (r1..r5, outer normalized to 1). IDs differ in the two
    inner ring positions, quantized on a grid with min separation."""
    bank = []
    levels = np.linspace(0.30, 0.78, 8)
    for a in range(8):
        for b in range(a + 2, 8):
            bank.append([levels[a], levels[a] + 0.08, levels[b], levels[b] + 0.08])
            if len(bank) == n_ids:
                return np.asarray(bank)
    return np.asarray(bank[:n_ids])


def render_cctag(
    marker_id: int, size: int = 129, supersample: int = 4
) -> np.ndarray:
    """White background, black rings at the bank radii + solid outer ring
    [0.88, 1.0] (float image in [0,1])."""
    edges = cctag_bank()[marker_id]
    s = size * supersample
    ax = (np.arange(s) + 0.5) / s * 2 - 1
    X, Y = np.meshgrid(ax, ax)
    r = np.sqrt(X**2 + Y**2) * (size / (size - 8.0))  # margin
    img = np.ones((s, s), np.float32)
    img[(r >= edges[0]) & (r < edges[1])] = 0.0
    img[(r >= edges[2]) & (r < edges[3])] = 0.0
    img[(r >= 0.88) & (r < 1.0)] = 0.0
    return img.reshape(size, supersample, size, supersample).mean((1, 3))


def _radial_profile(img, cx, cy, r_max, n_r=64, n_ang=48):
    """Angular-mean intensity profile I(r) around (cx, cy)."""
    rs = np.linspace(1.0, r_max, n_r)
    th = np.linspace(0, 2 * np.pi, n_ang, endpoint=False)
    u = cx + rs[:, None] * np.cos(th)[None, :]
    v = cy + rs[:, None] * np.sin(th)[None, :]
    H, W = img.shape
    ui = np.clip(np.round(u).astype(int), 0, W - 1)
    vi = np.clip(np.round(v).astype(int), 0, H - 1)
    return rs, img[vi, ui].mean(1)


def detect_cctags(
    img: np.ndarray,
    min_radius: float = 12.0,
    max_radius: float = 80.0,
    vote_threshold: float = 0.25,
) -> list[MarkerDetection]:
    """Detect concentric-ring markers: radial-symmetry center vote +
    profile-edge ring decoding against the bank."""
    img = np.asarray(img, np.float32)
    H, W = img.shape
    gy, gx = np.gradient(img)
    mag = np.hypot(gx, gy)
    strong = mag > max(0.05, np.percentile(mag, 92))
    ys, xs = np.nonzero(strong)
    if len(ys) == 0:
        return []
    nx = gx[ys, xs] / mag[ys, xs]
    ny = gy[ys, xs] / mag[ys, xs]
    acc = np.zeros((H, W), np.float32)
    # vote along +-gradient at a sweep of radii (edges of dark rings point
    # outward/inward; center accumulates at the true radius)
    for rad in np.linspace(min_radius, max_radius, 12):
        for sgn in (1.0, -1.0):
            cx = np.clip(np.round(xs + sgn * rad * nx).astype(int), 0, W - 1)
            cy = np.clip(np.round(ys + sgn * rad * ny).astype(int), 0, H - 1)
            np.add.at(acc, (cy, cx), mag[ys, xs])
    acc = ndimage.gaussian_filter(acc, 3.0)
    peak = ndimage.maximum_filter(acc, size=int(min_radius))
    cand = (acc == peak) & (acc > vote_threshold * acc.max())
    cys, cxs = np.nonzero(cand)
    order = np.argsort(-acc[cys, cxs])[:16]

    bank = cctag_bank()
    out = []
    taken = np.zeros((H, W), bool)
    for k in order:
        cy, cx = int(cys[k]), int(cxs[k])
        if taken[cy, cx]:
            continue
        r_lim = min(max_radius * 1.3, cx, cy, W - 1 - cx, H - 1 - cy)
        if r_lim < min_radius:
            continue
        rs, prof = _radial_profile(img, cx, cy, r_lim)
        dark = prof < 0.5
        # find the outer solid ring: last dark run
        runs = []
        i = 0
        while i < len(dark):
            if dark[i]:
                j = i
                while j < len(dark) and dark[j]:
                    j += 1
                runs.append((rs[i], rs[j - 1]))
                i = j
            else:
                i += 1
        if len(runs) != 3:
            continue
        outer_r = 0.5 * (runs[-1][0] / 0.88 + runs[-1][1] / 1.0)
        edges = np.array(
            [runs[0][0], runs[0][1], runs[1][0], runs[1][1]]
        ) / outer_r
        d = np.abs(bank - edges[None, :]).mean(1)
        best = int(np.argmin(d))
        if d[best] > 0.04:
            continue
        out.append(MarkerDetection(best, np.array([cx, cy], float), None, outer_r))
        y0, y1 = max(0, cy - int(outer_r)), min(H, cy + int(outer_r) + 1)
        x0, x1 = max(0, cx - int(outer_r)), min(W, cx + int(outer_r) + 1)
        taken[y0:y1, x0:x1] = True
    return out


# ---------------------------------------------------------------------------
# Regions bridge (matching interop)
# ---------------------------------------------------------------------------


def markers_to_features(dets: list[MarkerDetection], n_ids: int = 128):
    """(xy, scale, orientation, desc) arrays: one-hot uint8 descriptors at
    the marker id — the standard top-1 matcher then matches markers by
    exact id, like the reference's marker Regions."""
    if not dets:
        return (
            np.zeros((0, 2)),
            np.zeros(0),
            np.zeros(0),
            np.zeros((0, n_ids), np.uint8),
        )
    xy = np.stack([d.center for d in dets])
    scale = np.array([d.scale for d in dets])
    ori = np.zeros(len(dets))
    desc = np.zeros((len(dets), n_ids), np.uint8)
    for i, d in enumerate(dets):
        desc[i, d.marker_id % n_ids] = 255
    return xy, scale, ori, desc
