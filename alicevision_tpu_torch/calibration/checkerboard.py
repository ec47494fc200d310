"""Checkerboard x-corner detection + grid ordering.

Port of `alicevision_tpu/calibration/checkerboard.py` (ref:
src/aliceVision/calibration/checkerDetector.cpp — saddle point response,
non-max suppression, grid growing). The dense part (saddle response on the
port's `gaussian_blur`, NMS, the peaks' top-k) runs on the image's device;
the subpixel fit of the kept peaks and the grid ordering (board growing, the
global-lattice fallback) are the reference's host numpy, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..image.filtering import gaussian_blur


def xcorner_response(img: torch.Tensor, sigma: float = 1.5) -> torch.Tensor:
    """Saddle-point (x-corner) response: -det(Hessian) of the blurred image.

    Checkerboard corners are saddles: the Hessian has eigenvalues of
    opposite sign, so -det(H) peaks there and is ~0 on edges/blobs.
    """
    g = gaussian_blur(img, sigma)
    dxx = torch.roll(g, -1, 1) + torch.roll(g, 1, 1) - 2 * g
    dyy = torch.roll(g, -1, 0) + torch.roll(g, 1, 0) - 2 * g
    dxy = 0.25 * (
        torch.roll(g, (1, 1), (0, 1))
        + torch.roll(g, (-1, -1), (0, 1))
        - torch.roll(g, (1, -1), (0, 1))
        - torch.roll(g, (-1, 1), (0, 1))
    )
    return dxy * dxy - dxx * dyy  # = -det(H) >= 0 at saddles


def _nms_topk(resp: torch.Tensor, k: int, radius: int = 3):
    """Non-max suppression + top-k peak extraction (shifted compares on the
    device). Returns host (xs, ys, vals), the peaks in descending order."""
    m = resp
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            m = torch.where(resp >= torch.roll(resp, (dy, dx), (0, 1)), m, torch.full_like(m, -torch.inf))
    W = resp.shape[1]
    vals, idx = torch.topk(m.reshape(-1), k)
    idx, vals = idx.cpu().numpy(), vals.cpu().numpy()
    return idx % W, idx // W, vals


def subpixel_refine(resp: torch.Tensor, xs, ys) -> np.ndarray:
    """Quadratic subpixel refinement of response peaks (3x3 fits on the
    host): the 2D quadratic through each peak's 3x3 response neighbourhood
    gives the offset dx = -H^-1 g clipped to +-0.5."""
    H, W = resp.shape
    xs, ys = np.asarray(xs), np.asarray(ys)
    yy = np.clip(ys[:, None] + np.arange(-1, 2)[None, :], 0, H - 1)
    xx = np.clip(xs[:, None] + np.arange(-1, 2)[None, :], 0, W - 1)
    idx = torch.as_tensor(yy[:, :, None] * W + xx[:, None, :], device=resp.device)
    nb = resp.reshape(-1)[idx].cpu().numpy()  # (K, 3, 3): [1 + dy, 1 + dx]

    def tap(dy, dx):
        return nb[:, 1 + dy, 1 + dx]

    gx = 0.5 * (tap(0, 1) - tap(0, -1))
    gy = 0.5 * (tap(1, 0) - tap(-1, 0))
    gxx = tap(0, 1) + tap(0, -1) - 2 * tap(0, 0)
    gyy = tap(1, 0) + tap(-1, 0) - 2 * tap(0, 0)
    gxy = 0.25 * (tap(1, 1) + tap(-1, -1) - tap(1, -1) - tap(-1, 1))
    det = gxx * gyy - gxy * gxy
    det = np.where(np.abs(det) < 1e-12, np.float32(1e-12), det)
    dx = np.clip(-(gyy * gx - gxy * gy) / det, -0.5, 0.5)
    dy = np.clip(-(gxx * gy - gxy * gx) / det, -0.5, 0.5)
    return np.stack([xs.astype(np.float32) + dx, ys.astype(np.float32) + dy], -1)


def _grow_board(pts: np.ndarray, resp_kept: np.ndarray, rows: int, cols: int):
    """Grow a corner lattice from a seed by local parallelogram prediction
    (ref: checkerDetector.cpp board growing — occlusion-tolerant, handles
    perspective/distortion because each step extrapolates LOCALLY instead
    of fitting one global lattice). Returns (rows*cols, 2) or None."""
    from scipy.spatial import cKDTree

    n_pts = len(pts)
    if n_pts < rows * cols:
        return None
    tree = cKDTree(pts)

    # seed: strongest corner with 4 roughly-lattice neighbors
    order = np.argsort(-resp_kept)
    seed = None
    for cand in order[: max(16, n_pts // 4)]:
        d, idx = tree.query(pts[cand], k=min(9, n_pts))
        nb = idx[1:]
        if len(nb) < 4:
            continue
        v = pts[nb] - pts[cand]
        ln = np.linalg.norm(v, axis=1)
        base = np.median(ln[:4])
        ok = (ln > 0.6 * base) & (ln < 1.6 * base)
        vv = v[ok]
        if len(vv) < 4:
            continue
        # need two near-opposite pairs
        e1 = vv[0] / np.linalg.norm(vv[0])
        dots = vv @ e1 / np.linalg.norm(vv, axis=1)
        if (dots < -0.8).any() and (np.abs(dots) < 0.5).any():
            perp = vv[np.abs(dots) < 0.5][0]
            seed = (cand, vv[0], perp)
            break
    if seed is None:
        return None
    c0, v_col, v_row = seed

    grid = {(0, 0): int(c0)}
    pos = {(0, 0): pts[c0]}
    pred0 = {(0, 1): pts[c0] + v_col, (0, -1): pts[c0] - v_col,
             (1, 0): pts[c0] + v_row, (-1, 0): pts[c0] - v_row}
    used = {int(c0)}
    step_len = 0.5 * (np.linalg.norm(v_col) + np.linalg.norm(v_row))
    tol = 0.35 * step_len

    def predict(cell):
        """Parallelogram / extrapolation predictions from known neighbors."""
        i, j = cell
        preds = []
        # linear extrapolation along each axis: p(c) = 2 p(c-d) - p(c-2d)
        for di, dj in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            a = (i - di, j - dj)
            b = (i - 2 * di, j - 2 * dj)
            if a in pos and b in pos:
                preds.append(2 * pos[a] - pos[b])
        # parallelogram completion p(i,j) = p(i,j-1) + p(i-1,j) - p(i-1,j-1)
        for di, dj in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
            a = (i - di, j)
            b = (i, j - dj)
            c = (i - di, j - dj)
            if a in pos and b in pos and c in pos:
                preds.append(pos[a] + pos[b] - pos[c])
        if cell in pred0 and not preds:
            preds.append(pred0[cell])
        return preds

    changed = True
    max_cells = 4 * rows * cols
    while changed and len(grid) < max_cells:
        changed = False
        frontier = set()
        for (i, j) in list(grid.keys()) + list(pred0.keys()):
            for di, dj in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                c = (i + di, j + dj)
                if c not in pos:
                    frontier.add(c)
        for cell in frontier:
            preds = predict(cell)
            if not preds:
                continue
            p = np.mean(preds, axis=0)
            d, k = tree.query(p)
            if d < tol and int(k) not in used:
                grid[cell] = int(k)
                pos[cell] = pts[int(k)]
                used.add(int(k))
                changed = True
            elif d >= tol and len(preds) >= 2:
                # occlusion hole: accept the prediction as a virtual corner
                # so growth continues past it (position refined by later
                # parallelograms); it only survives if surrounded
                pos[cell] = p
                changed = True

    # best complete rows x cols window over REAL detections
    cells = np.array(list(grid.keys()))
    if len(cells) < rows * cols:
        return None
    imin, jmin = cells.min(0)
    imax, jmax = cells.max(0)
    best = None
    best_score = -np.inf
    for h, w in ((rows, cols), (cols, rows)):
        for i0 in range(imin, imax - h + 2):
            for j0 in range(jmin, jmax - w + 2):
                window = [(i0 + i, j0 + j) for i in range(h) for j in range(w)]
                if all(c in grid for c in window):
                    s = sum(resp_kept[grid[c]] for c in window)
                    if s > best_score:
                        best_score = s
                        if h == rows:
                            best = np.array([pos[c] for c in window])
                        else:  # transpose ordering to rows x cols
                            best = np.array(
                                [pos[(i0 + i, j0 + j)] for j in range(w) for i in range(h)]
                            )
    return best


def detect_checkerboard(img, rows: int, cols: int, sigma: float = 1.5, device="cuda") -> np.ndarray | None:
    """Detect an (rows x cols) inner-corner grid in img (H, W), a tensor
    (computed on its device) or a host array (on `device`). Returns
    (rows*cols, 2) pixel coords ordered row-major, or None if the full grid
    isn't found.

    Two passes: the board-growing detector (local extrapolation, robust to
    perspective/distortion/occlusion — checkerDetector.cpp analog) and the
    global-lattice fallback for clean fronto-parallel boards."""
    if not isinstance(img, torch.Tensor):
        img = torch.as_tensor(np.asarray(img), dtype=torch.float32, device=resolve_device(device))
    resp = xcorner_response(img, sigma)
    n = rows * cols
    xs_np, ys_np, vals_np = _nms_topk(resp, n * 3)
    thresh = float(vals_np[n - 1]) * 0.2 if len(vals_np) >= n else 0.0
    keep = vals_np > max(thresh, 1e-8)
    if keep.sum() >= n:
        pts = subpixel_refine(resp, xs_np[keep], ys_np[keep])
        grown = _grow_board(pts, vals_np[keep], rows, cols)
        if grown is not None:
            return grown
    return _detect_checkerboard_lattice(resp, rows, cols)


def _detect_checkerboard_lattice(resp: torch.Tensor, rows: int, cols: int) -> np.ndarray | None:
    """Global-lattice ordering (fallback method): dominant neighbor axes,
    integer snapping, best complete window."""
    n = rows * cols
    xs, ys, vals = _nms_topk(resp, n * 3)
    thresh = float(vals[n - 1]) * 0.2 if len(vals) >= n else 0.0
    keep = vals > max(thresh, 1e-8)
    pts = np.stack([xs[keep], ys[keep]], -1).astype(np.float64)
    resp_kept = vals[keep]
    if len(pts) < n:
        return None

    # Estimate lattice axes from the two dominant neighbour offsets.
    from scipy.spatial import cKDTree

    tree = cKDTree(pts)
    d, idx = tree.query(pts, k=min(5, len(pts)))
    offs = []
    for i in range(len(pts)):
        for j in idx[i][1:]:
            offs.append(pts[j] - pts[i])
    offs = np.array(offs)
    # principal directions via clustering on angle (mod 180 deg)
    ang = np.arctan2(offs[:, 1], offs[:, 0]) % np.pi
    hist, edges = np.histogram(ang, bins=36)
    a1 = edges[hist.argmax()] + (edges[1] - edges[0]) / 2
    # second axis: strongest bin at least 45 deg away
    mask = np.minimum(np.abs(edges[:-1] - a1), np.pi - np.abs(edges[:-1] - a1)) > np.pi / 4
    if not mask.any():
        return None
    a2 = edges[:-1][mask][hist[mask].argmax()] + (edges[1] - edges[0]) / 2
    e1 = np.array([np.cos(a1), np.sin(a1)])
    e2 = np.array([np.cos(a2), np.sin(a2)])
    step1 = np.median(np.abs(offs @ e1)[np.abs(offs @ e1) > 2])
    step2 = np.median(np.abs(offs @ e2)[np.abs(offs @ e2) > 2])

    # Project points onto lattice coords and snap to integers.
    origin = pts.mean(0)
    A = np.stack([e1 * step1, e2 * step2], axis=1)  # (2, 2)
    uv = np.linalg.solve(A, (pts - origin).T).T
    ij = np.floor(uv + 0.5).astype(int)  # avoid half-to-even collapse
    # normalize to start at (0, 0)
    ij -= ij.min(0)
    # Assign each lattice cell the strongest-response point landing on it
    # (false positives lose to true saddles), then pick the rows x cols
    # window with the highest total response among all complete windows.
    got: dict = {}
    score: dict = {}
    for p, (i, j), r in zip(pts, ij, resp_kept):
        if (i, j) not in got or r > score[(i, j)]:
            got[(i, j)] = p
            score[(i, j)] = float(r)

    best_grid = None
    best_score = -np.inf
    for w_cols, w_rows in ((cols, rows), (rows, cols)):
        for di in range(ij[:, 0].max() - w_cols + 2):
            for dj in range(ij[:, 1].max() - w_rows + 2):
                if w_cols == cols:
                    cells = [(di + i, dj + j) for j in range(w_rows) for i in range(w_cols)]
                else:
                    cells = [(di + i, dj + j) for i in range(w_cols) for j in range(w_rows)]
                if all(c in got for c in cells):
                    s = sum(score[c] for c in cells)
                    if s > best_score:
                        best_score = s
                        best_grid = np.array([got[c] for c in cells])
    return best_grid
