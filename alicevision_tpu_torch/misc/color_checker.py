"""ColorChecker (24-patch) detection + color extraction.

Port of `alicevision_tpu/misc/color_checker.py`, host numpy as there (the
JAX module uses no device), copied. Counterpart of the reference's
color-checker tools
(ref: src/software/utils/main_colorCheckerDetection.cpp — OpenCV mcc-based
detector feeding color calibration). Classical pipeline: uniform low-
variance patch segmentation -> component centroids -> dominant-lattice grid
fit (the same axis-estimation approach as the checkerboard detector) ->
row-major ordering -> mean patch colors.
"""

from __future__ import annotations

import numpy as np

# sRGB reference values of the classic 24-patch Macbeth chart, row-major
# (public colorimetric data).
MACBETH_SRGB = np.array(
    [
        [115, 82, 68], [194, 150, 130], [98, 122, 157], [87, 108, 67],
        [133, 128, 177], [103, 189, 170],
        [214, 126, 44], [80, 91, 166], [193, 90, 99], [94, 60, 108],
        [157, 188, 64], [224, 163, 46],
        [56, 61, 150], [70, 148, 73], [175, 54, 60], [231, 199, 31],
        [187, 86, 149], [8, 133, 161],
        [243, 243, 242], [200, 200, 200], [160, 160, 160], [122, 122, 121],
        [85, 85, 85], [52, 52, 52],
    ],
    np.float64,
) / 255.0


def detect_color_checker(
    rgb: np.ndarray,  # (H, W, 3) in [0, 1]
    rows: int = 4,
    cols: int = 6,
    min_patch_px: int = 40,
):
    """Detect the patch grid. Returns (centers (24, 2), colors (24, 3)) in
    row-major order, or None."""
    import scipy.ndimage as ndi

    gray = rgb @ np.array([0.299, 0.587, 0.114])
    # local variance: uniform patches score low. Threshold against the
    # noise floor (median variance) rather than a fixed percentile — patch
    # and background smoothness are indistinguishable by rank alone.
    mean = ndi.uniform_filter(gray, 7)
    var = ndi.uniform_filter(gray * gray, 7) - mean * mean
    floor = np.median(var)
    flat = var < max(3.0 * floor, 1e-6)
    # remove thin connections between patches
    flat = ndi.binary_erosion(flat, iterations=2)
    label, n = ndi.label(flat)
    if n < rows * cols:
        return None
    sizes = ndi.sum_labels(np.ones_like(gray), label, index=np.arange(1, n + 1))
    order = np.argsort(-sizes)
    cands = []
    med = np.median(sizes[order[: rows * cols]])
    for li in order:
        if sizes[li] < min_patch_px:
            break
        if not (0.3 * med <= sizes[li] <= 3.0 * med):
            continue
        ys, xs = np.nonzero(label == li + 1)
        # compactness: bounding-box fill ratio
        bb = (ys.max() - ys.min() + 1) * (xs.max() - xs.min() + 1)
        if sizes[li] / bb < 0.6:
            continue
        # background regions reach the image border; chart patches don't
        Hh, Ww = gray.shape
        if ys.min() <= 2 or xs.min() <= 2 or ys.max() >= Hh - 3 or xs.max() >= Ww - 3:
            continue
        # patches must have near-square aspect
        asp = (xs.max() - xs.min() + 1) / max(ys.max() - ys.min() + 1, 1)
        if not (0.5 <= asp <= 2.0):
            continue
        cands.append([xs.mean(), ys.mean()])
    if len(cands) < rows * cols:
        return None
    pts = np.array(cands)

    # dominant lattice axes from neighbour offsets (as in checkerboard.py)
    from scipy.spatial import cKDTree

    tree = cKDTree(pts)
    d, idx = tree.query(pts, k=min(5, len(pts)))
    offs = []
    for i in range(len(pts)):
        for j in idx[i][1:]:
            offs.append(pts[j] - pts[i])
    offs = np.array(offs)
    ang = np.arctan2(offs[:, 1], offs[:, 0]) % np.pi
    hist, edges = np.histogram(ang, bins=36)
    bw = edges[1] - edges[0]

    def refine_angle(a0):
        # circular mean (period pi) of offsets within +-1 bin of the peak —
        # the raw bin center is ~2.5 deg quantized, enough to skew the
        # lattice rounding at the grid extremes
        d = np.minimum(np.abs(ang - a0), np.pi - np.abs(ang - a0))
        sel = d < 1.5 * bw
        if not sel.any():
            return a0
        return 0.5 * np.angle(np.exp(2j * ang[sel]).mean()) % np.pi

    a1 = refine_angle(edges[hist.argmax()] + bw / 2)
    mask = np.minimum(np.abs(edges[:-1] - a1), np.pi - np.abs(edges[:-1] - a1)) > np.pi / 4
    if not mask.any():
        return None
    a2 = refine_angle(edges[:-1][mask][hist[mask].argmax()] + bw / 2)
    e1 = np.array([np.cos(a1), np.sin(a1)])
    e2 = np.array([np.cos(a2), np.sin(a2)])
    s1 = np.median(np.abs(offs @ e1)[np.abs(offs @ e1) > 3])
    s2 = np.median(np.abs(offs @ e2)[np.abs(offs @ e2) > 3])
    A = np.stack([e1 * s1, e2 * s2], axis=1)
    uv = np.linalg.solve(A, (pts - pts.mean(0)).T).T
    ij = np.floor(uv + 0.5).astype(int)  # avoid half-to-even collapse
    ij -= ij.min(0)
    # Refine the lattice basis by least squares — the histogram-binned axis
    # angles (~2.5 deg quantization) skew assignments at the grid extremes.
    for _ in range(3):
        M = np.stack([np.ones(len(pts)), ij[:, 0], ij[:, 1]], axis=1)
        sol, *_ = np.linalg.lstsq(M, pts, rcond=None)  # rows: o, v1, v2
        o, v1, v2 = sol
        B = np.stack([v1, v2], axis=1)
        uv = np.linalg.solve(B, (pts - o).T).T
        ij = np.floor(uv + 0.5).astype(int)  # avoid half-to-even collapse
        ij -= ij.min(0)

    got = {}
    for p, (i, j) in zip(pts, ij):
        got[(i, j)] = p
    grid = None
    for w_c, w_r in ((cols, rows), (rows, cols)):
        for di in range(ij[:, 0].max() - w_c + 2):
            for dj in range(ij[:, 1].max() - w_r + 2):
                if w_c == cols:
                    cells = [(di + i, dj + j) for j in range(w_r) for i in range(w_c)]
                else:
                    cells = [(di + i, dj + j) for i in range(w_c) for j in range(w_r)]
                if all(c in got for c in cells):
                    grid = np.array([got[c] for c in cells])
                    break
            if grid is not None:
                break
        if grid is not None:
            break
    if grid is None:
        return None

    # canonical image orientation: rows top-to-bottom, columns left-to-right
    g = grid.reshape(rows, cols, 2)
    if g[0, 0, 0] > g[0, -1, 0]:
        g = g[:, ::-1]
    if g[0, 0, 1] > g[-1, 0, 1]:
        g = g[::-1]
    grid = g.reshape(-1, 2).copy()

    colors = []
    r = max(2, int(0.15 * min(s1, s2)))
    for cx, cy in grid:
        x0, x1 = int(cx - r), int(cx + r + 1)
        y0, y1 = int(cy - r), int(cy + r + 1)
        colors.append(rgb[max(0, y0) : y1, max(0, x0) : x1].reshape(-1, 3).mean(0))
    colors = np.array(colors)

    # chart orientation: the neutral (grayscale) row belongs at the bottom —
    # a 180-degree physical rotation flips both axes
    def neutrality(c):
        return -np.std(c, axis=-1).mean()

    if neutrality(colors[:cols]) > neutrality(colors[-cols:]):
        grid = grid[::-1].copy()
        colors = colors[::-1].copy()
    return grid, colors


def color_correction_matrix(measured: np.ndarray, reference: np.ndarray = None):
    """Least-squares 3x4 affine color correction from measured -> reference
    patch colors (the downstream use of the detector)."""
    if reference is None:
        reference = MACBETH_SRGB
    X = np.concatenate([measured, np.ones((len(measured), 1))], axis=1)
    M, *_ = np.linalg.lstsq(X, reference, rcond=None)
    return M.T  # (3, 4)


def apply_color_correction(rgb: np.ndarray, M: np.ndarray) -> np.ndarray:
    H, W, _ = rgb.shape
    X = np.concatenate([rgb.reshape(-1, 3), np.ones((H * W, 1))], axis=1)
    return np.clip(X @ M.T, 0, 1).reshape(H, W, 3)
