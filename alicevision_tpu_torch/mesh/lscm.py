"""Least-squares conformal maps (LSCM) chart parameterization.

A host copy of `alicevision_tpu/mesh/lscm.py`, the counterpart of the reference's Geogram-backed LSCM unwrap
(ref: src/aliceVision/mesh/Texturing.cpp:61-74 `unwrap()` dispatching to
LSCM for small charts, mesh/UVAtlas.hpp packing). The parameterization is
the classic Lévy et al. 2002 formulation: each triangle, expressed in an
isometric local 2D frame, contributes the conformality residual

    (1 / sqrt(2 A_T)) * sum_j W_j z_j  ≈ 0,   z_j = u_j + i v_j

with W_1 = (x_3 - x_2) + i (y_3 - y_2) (cyclic) and two pinned vertices
removing the similarity gauge. The sparse least-squares system is solved
host-side with scipy (irregular sparsity — the same reasoning that keeps
Delaunay/maxflow on host; charts are small so this is off the hot path).
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.linalg import lsqr


def _local_frames(V: np.ndarray, F: np.ndarray):
    """Isometric per-triangle 2D coordinates (T, 3, 2) and areas (T,)."""
    p0, p1, p2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    n = np.cross(e1, e2)
    a2 = np.linalg.norm(n, axis=1)  # 2 * area
    x_axis = e1 / np.maximum(np.linalg.norm(e1, axis=1, keepdims=True), 1e-12)
    nn = n / np.maximum(a2[:, None], 1e-12)
    y_axis = np.cross(nn, x_axis)
    x1 = np.einsum("ij,ij->i", e1, x_axis)
    x2 = np.einsum("ij,ij->i", e2, x_axis)
    y2 = np.einsum("ij,ij->i", e2, y_axis)
    loc = np.zeros((len(F), 3, 2))
    loc[:, 1, 0] = x1
    loc[:, 2, 0] = x2
    loc[:, 2, 1] = y2
    return loc, 0.5 * a2


def lscm_unwrap(
    V: np.ndarray,  # (n, 3) chart vertices
    F: np.ndarray,  # (T, 3) indices into V
    pins: tuple | None = None,
) -> np.ndarray:
    """Conformal UV coordinates (n, 2) for one chart.

    `pins` = (i, j) vertex indices to fix; defaults to the two vertices
    farthest apart along the chart's largest bounding-box axis (the
    standard gauge choice). Raises ValueError on degenerate charts.
    """
    n = len(V)
    T = len(F)
    if n < 3 or T < 1:
        raise ValueError("chart too small for LSCM")

    if pins is None:
        ext = V.max(0) - V.min(0)
        ax = int(np.argmax(ext))
        i = int(np.argmin(V[:, ax]))
        j = int(np.argmax(V[:, ax]))
        if i == j:
            raise ValueError("degenerate chart (zero extent)")
        pins = (i, j)
    pi, pj = pins
    pin_dist = float(np.linalg.norm(V[pj] - V[pi]))
    if pin_dist < 1e-12:
        raise ValueError("coincident pin vertices")

    loc, area = _local_frames(V, F)
    if np.any(area < 1e-16):
        # zero-area faces poison the system; drop them
        keep = area >= 1e-16
        F = F[keep]
        loc = loc[keep]
        area = area[keep]
        T = len(F)
        if T < 1:
            raise ValueError("all faces degenerate")

    # W_j per triangle (complex), scaled by 1/sqrt(2A)
    s = 1.0 / np.sqrt(np.maximum(2.0 * area, 1e-16))
    W = np.stack(
        [
            (loc[:, 2] - loc[:, 1]),
            (loc[:, 0] - loc[:, 2]),
            (loc[:, 1] - loc[:, 0]),
        ],
        axis=1,
    )  # (T, 3, 2) -> real/imag parts
    Wr = W[..., 0] * s[:, None]
    Wi = W[..., 1] * s[:, None]

    # unknown ordering: free vertices, [u... v...]
    free = np.array([k for k in range(n) if k not in (pi, pj)], np.int64)
    col_of = -np.ones(n, np.int64)
    col_of[free] = np.arange(len(free))
    nf = len(free)

    # pinned UVs: pi -> (0, 0), pj -> (d, 0) keeps the chart's true scale
    uv_pin = {pi: (0.0, 0.0), pj: (pin_dist, 0.0)}

    rows, cols, vals = [], [], []
    rhs = np.zeros(2 * T)
    for t in range(T):
        for jloc in range(3):
            vtx = int(F[t, jloc])
            wr, wi = Wr[t, jloc], Wi[t, jloc]
            if vtx in uv_pin:
                u0, v0 = uv_pin[vtx]
                # real row: wr*u - wi*v ; imag row: wi*u + wr*v
                rhs[2 * t] -= wr * u0 - wi * v0
                rhs[2 * t + 1] -= wi * u0 + wr * v0
            else:
                c = col_of[vtx]
                rows += [2 * t, 2 * t, 2 * t + 1, 2 * t + 1]
                cols += [c, nf + c, c, nf + c]
                vals += [wr, -wi, wi, wr]
    A = coo_matrix((vals, (rows, cols)), shape=(2 * T, 2 * nf)).tocsr()
    sol = lsqr(A, rhs, atol=1e-10, btol=1e-10, iter_lim=4 * (2 * nf + 100))[0]

    uv = np.zeros((n, 2))
    uv[free, 0] = sol[:nf]
    uv[free, 1] = sol[nf:]
    uv[pi] = uv_pin[pi]
    uv[pj] = uv_pin[pj]
    if not np.all(np.isfinite(uv)):
        raise ValueError("LSCM solve diverged")
    return uv


def conformal_error(V: np.ndarray, F: np.ndarray, uv: np.ndarray) -> float:
    """Mean per-corner angle distortion (radians) between 3D and UV —
    the quantity LSCM minimizes; used by tests and chart quality gates."""

    def angles(P):
        out = []
        for k in range(3):
            a = P[:, (k + 1) % 3] - P[:, k]
            b = P[:, (k + 2) % 3] - P[:, k]
            na = np.linalg.norm(a, axis=1)
            nb = np.linalg.norm(b, axis=1)
            cosv = np.einsum("ij,ij->i", a, b) / np.maximum(na * nb, 1e-12)
            out.append(np.arccos(np.clip(cosv, -1, 1)))
        return np.stack(out, 1)

    a3 = angles(V[F])
    a2 = angles(uv[F])
    return float(np.mean(np.abs(a3 - a2)))
