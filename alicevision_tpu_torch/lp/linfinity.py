"""L-infinity computer vision via LP bisection.

Host copy of `alicevision_tpu/lp/linfinity.py` (numpy + scipy; the JAX
package's `lp/__init__` imports jax). The counterpart of the reference's
linear-programming battery (ref: src/aliceVision/linearProgramming/, lInfinityCV/
lInfinityCV.hpp, resection.hpp, triangulation.hpp,
global_translations_fromTij.hpp, bisectionLP.hpp). The reference solves
these with OSI/Clp; the problems are tiny and irregular, and off the
device path (they seed or globalize solutions the batched optimizers then
refine), so they run on the host with scipy's HiGHS LP solver, the split
the reference makes (Clp on the CPU next to CUDA kernels).

Every solver is the classic quasi-convex formulation: the sublevel sets of
the L-infinity reprojection error are convex, so `min gamma` reduces to
bisection over gamma with an LP feasibility test per step
(ref: lInfinityCV/bisectionLP.hpp:24-96).
"""

from __future__ import annotations

import numpy as np

try:  # scipy is baked into the image; gate anyway for lean installs
    from scipy.optimize import linprog

    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False

_DEPTH_EPS = 1e-6


def _require_scipy():
    if not _HAVE_SCIPY:  # pragma: no cover
        raise RuntimeError("scipy is required for the L-infinity LP solvers")


def _feasible(A_ub, b_ub, n_var, bounds=None):
    """LP feasibility: does {x : A x <= b} admit a point? (zero objective)."""
    res = linprog(
        c=np.zeros(n_var),
        A_ub=A_ub,
        b_ub=b_ub,
        bounds=bounds if bounds is not None else [(None, None)] * n_var,
        method="highs",
    )
    return (res.status == 0), (res.x if res.status == 0 else None)


def triangulate_linf(Ps, uvs, gamma_max=2.0, tol=1e-6, max_iter=40):
    """N-view L-infinity triangulation by bisection
    (ref: lInfinityCV/triangulation.hpp:30-92).

    Ps: (N, 3, 4) projection matrices, uvs: (N, 2) pixel observations.
    Minimizes max_i ||uv_i - proj_i(X)||_inf subject to positive depths.
    Returns (X (3,), gamma) or (None, inf) if infeasible at gamma_max.
    """
    _require_scipy()
    Ps = np.asarray(Ps, np.float64)
    uvs = np.asarray(uvs, np.float64)
    N = Ps.shape[0]

    def build(gamma):
        # For each view: |(P0 - u P2) [X;1]| <= gamma * P2 [X;1]
        #                |(P1 - v P2) [X;1]| <= gamma * P2 [X;1]
        # and cheirality P2 [X;1] >= eps. All linear in X.
        rows, rhs = [], []
        for i in range(N):
            p0, p1, p2 = Ps[i]
            u, v = uvs[i]
            for num in (p0 - u * p2, p1 - v * p2):
                rows.append(num[:3] - gamma * p2[:3])
                rhs.append(gamma * p2[3] - num[3])
                rows.append(-num[:3] - gamma * p2[:3])
                rhs.append(gamma * p2[3] + num[3])
            rows.append(-p2[:3])
            rhs.append(p2[3] - _DEPTH_EPS)
        return np.array(rows), np.array(rhs)

    lo, hi = 0.0, float(gamma_max)
    A, b = build(hi)
    ok, x = _feasible(A, b, 3)
    if not ok:
        return None, float("inf")
    best = x
    for _ in range(max_iter):
        if hi - lo < tol:
            break
        mid = 0.5 * (lo + hi)
        A, b = build(mid)
        ok, x = _feasible(A, b, 3)
        if ok:
            hi, best = mid, x
        else:
            lo = mid
    return best, hi


def resection_linf(world, uv, gamma_max=2.0, tol=1e-6, max_iter=40):
    """L-infinity camera resection by bisection
    (ref: lInfinityCV/resection.hpp:28-90).

    world: (N, 3) points, uv: (N, 2) observations on the normalized plane
    (or pixels — gamma is then in pixels). Solves for the full 3x4 P with
    the gauge P[2, 3] = 1 (depth-positive normalization), minimizing
    max_i L_inf reprojection. Returns (P (3, 4), gamma) or (None, inf).
    """
    _require_scipy()
    world = np.asarray(world, np.float64)
    uv = np.asarray(uv, np.float64)
    N = world.shape[0]
    Xh = np.concatenate([world, np.ones((N, 1))], axis=1)  # (N, 4)

    # Unknowns: 11 — P flattened as [P00..P03, P10..P13, P20..P22], P23 := 1.
    def build(gamma):
        rows, rhs = [], []
        for i in range(N):
            x4 = Xh[i]
            depth_coeff = np.zeros(11)
            depth_coeff[8:11] = -x4[:3]
            rows.append(depth_coeff)
            rhs.append(x4[3] - _DEPTH_EPS)  # P2.X >= eps
            for axis in range(2):
                u = uv[i, axis]
                # |P_axis.X - u P2.X| <= gamma P2.X
                base = np.zeros(11)
                base[axis * 4 : axis * 4 + 4] = x4
                u_term = np.zeros(11)
                u_term[8:11] = u * x4[:3]
                g_term = np.zeros(11)
                g_term[8:11] = gamma * x4[:3]
                #  (P_axis.X) - u (P2.X) - gamma (P2.X) <= u + gamma  (P23=1)
                rows.append(base - u_term - g_term)
                rhs.append(u * x4[3] + gamma * x4[3])
                rows.append(-(base - u_term) - g_term)
                rhs.append(-u * x4[3] + gamma * x4[3])
        return np.array(rows), np.array(rhs)

    lo, hi = 0.0, float(gamma_max)
    A, b = build(hi)
    ok, x = _feasible(A, b, 11)
    if not ok:
        return None, float("inf")
    best = x
    for _ in range(max_iter):
        if hi - lo < tol:
            break
        mid = 0.5 * (lo + hi)
        A, b = build(mid)
        ok, x = _feasible(A, b, 11)
        if ok:
            hi, best = mid, x
        else:
            lo = mid
    P = np.concatenate([best, [1.0]]).reshape(3, 4)
    return P, hi


def translations_from_relative_linf(
    n_views,
    edges,
    directions,
    fixed_view=0,
    gamma_max=2.0,
    tol=1e-6,
    max_iter=40,
):
    """Global camera centers from pairwise translation directions, L-inf
    (ref: lInfinityCV/global_translations_fromTij.hpp:30-150 — the Tij
    formulation with per-edge scales lambda_ij >= 1).

    edges: (E, 2) int pairs (i, j); directions: (E, 3) unit vectors d_ij
    pointing from camera i to camera j in the *world* frame (rotations
    already applied). Solves for centers c and scales lambda with
    |c_j - c_i - lambda_e d_e| <= gamma * lambda_e (componentwise),
    lambda_e >= 1, c_fixed = 0, via bisection on gamma.

    Returns (centers (n_views, 3), gamma).
    """
    _require_scipy()
    edges = np.asarray(edges, np.int64)
    directions = np.asarray(directions, np.float64)
    E = edges.shape[0]
    nvar = 3 * n_views + E  # centers + per-edge scales

    def cvar(i, axis):
        return 3 * i + axis

    def build(gamma):
        rows, rhs = [], []
        for e in range(E):
            i, j = edges[e]
            lam = 3 * n_views + e
            for axis in range(3):
                d = directions[e, axis]
                # c_j - c_i - lam (d + gamma) <= 0
                r = np.zeros(nvar)
                r[cvar(j, axis)] = 1.0
                r[cvar(i, axis)] = -1.0
                r[lam] = -(d + gamma)
                rows.append(r)
                rhs.append(0.0)
                # -(c_j - c_i) + lam (d - gamma) <= 0
                r = np.zeros(nvar)
                r[cvar(j, axis)] = -1.0
                r[cvar(i, axis)] = 1.0
                r[lam] = d - gamma
                rows.append(r)
                rhs.append(0.0)
        return np.array(rows), np.array(rhs)

    bounds = [(None, None)] * (3 * n_views) + [(1.0, None)] * E
    for axis in range(3):
        bounds[cvar(fixed_view, axis)] = (0.0, 0.0)

    lo, hi = 0.0, float(gamma_max)
    A, b = build(hi)
    ok, x = _feasible(A, b, nvar, bounds)
    if not ok:
        return None, float("inf")
    best = x
    for _ in range(max_iter):
        if hi - lo < tol:
            break
        mid = 0.5 * (lo + hi)
        A, b = build(mid)
        ok, x = _feasible(A, b, nvar, bounds)
        if ok:
            hi, best = mid, x
        else:
            lo = mid
    return best[: 3 * n_views].reshape(n_views, 3), hi
