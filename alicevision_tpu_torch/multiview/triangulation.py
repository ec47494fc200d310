"""Triangulation — batched DLT, midpoint, and masked N-view variants.

Port of `alicevision_tpu/multiview/triangulation.py` (ref:
src/aliceVision/multiview/triangulation/triangulationDLT.hpp,
Triangulation.hpp:105 N-view iterative, NViewsTriangulationLORansac.hpp:48).
Every function is batched over leading dimensions; the N-view forms take a
fixed observation capacity K with a validity mask instead of ragged lists.
Null vectors come from `torch.linalg.eigh` of the 4x4 Gram matrix.
"""

from __future__ import annotations

import torch

from ..numeric import f32_matmuls

_EPS = 1e-12


def _dehomogenize(X: torch.Tensor) -> torch.Tensor:
    w = X[..., 3:]
    return X[..., :3] / torch.where(torch.abs(w) < _EPS, torch.full_like(w, _EPS), w)


def _smallest_right_singular(A: torch.Tensor) -> torch.Tensor:
    """Right singular vector of the smallest singular value via eigh(A^T A)."""
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return V[..., :, 0]


@f32_matmuls
def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Two-view DLT. P: (..., 3, 4) projection matrices, x: (..., 2) pixels.
    Returns euclidean points (..., 3)."""
    rows = torch.stack(
        [
            x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ],
        dim=-2,
    )  # (..., 4, 4)
    return _dehomogenize(_smallest_right_singular(rows))


@f32_matmuls
def triangulate_nview(P: torch.Tensor, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked N-view DLT. P: (..., K, 3, 4), x: (..., K, 2), mask: (..., K).
    Invalid rows are zeroed; rows are norm-balanced for float32."""
    r0 = x[..., 0, None] * P[..., 2, :] - P[..., 0, :]  # (..., K, 4)
    r1 = x[..., 1, None] * P[..., 2, :] - P[..., 1, :]
    A = torch.cat([r0, r1], dim=-2)  # (..., 2K, 4)
    if mask is not None:
        A = A * torch.cat([mask, mask], dim=-1).to(A.dtype)[..., None]
    A = A / torch.clamp(torch.linalg.norm(A, dim=-1, keepdim=True), min=_EPS)
    return _dehomogenize(_smallest_right_singular(A))


@f32_matmuls
def triangulate_midpoint(centers: torch.Tensor, rays: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """N-view midpoint: the least-squares point closest to all rays.
    centers, rays: (..., K, 3) (rays in the world frame)."""
    d = rays / torch.clamp(torch.linalg.norm(rays, dim=-1, keepdim=True), min=_EPS)
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    Pk = eye - d[..., :, None] * d[..., None, :]  # (..., K, 3, 3)
    if mask is not None:
        Pk = Pk * mask[..., None, None].to(d.dtype)
    A = torch.sum(Pk, dim=-3) + 1e-9 * eye  # Tikhonov guard for parallel rays
    b = torch.sum(torch.einsum("...kij,...kj->...ki", Pk, centers), dim=-2)
    return torch.linalg.solve_ex(A, b[..., :, None])[0][..., 0]


def reprojection_errors(P: torch.Tensor, x: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Reprojection error of X (..., 3) in views P (..., K, 3, 4) against
    x (..., K, 2). Returns (..., K)."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    proj = torch.einsum("...kij,...j->...ki", P, Xh)
    z = proj[..., 2:]
    uv = proj[..., :2] / torch.where(torch.abs(z) < _EPS, torch.full_like(z, _EPS), z)
    return torch.linalg.norm(uv - x, dim=-1)


def depths(P: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Projective depth of X (..., 3) in views P (..., K, 3, 4) -> (..., K)."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    return torch.einsum("...kj,...j->...k", P[..., 2, :], Xh)


def triangulate_nview_robust(
    P: torch.Tensor,
    x: torch.Tensor,
    mask: torch.Tensor | None = None,
    threshold_px: float = 4.0,
    max_pairs: int = 28,
    lo_iters: int = 2,
):
    """LO-RANSAC N-view triangulation, batched over tracks: every view pair
    up to `max_pairs` (i < j, lexicographic, masked) is triangulated by
    two-view DLT, scored by inlier count then truncated error over the
    track, and the winner is refit `lo_iters` times by masked N-view DLT on
    its inliers. Returns (X (..., 3), inliers (..., K), valid (...,))."""
    K = P.shape[-3]
    if mask is None:
        mask = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
    ii, jj = torch.triu_indices(K, K, offset=1, device=x.device)
    ii, jj = ii[:max_pairs], jj[:max_pairs]

    pair_ok = mask[..., ii] & mask[..., jj]  # (..., Q)
    X0 = triangulate_dlt(P[..., ii, :, :], P[..., jj, :, :], x[..., ii, :], x[..., jj, :])  # (..., Q, 3)
    Pb = P[..., None, :, :, :].expand(X0.shape[:-1] + (K, 3, 4))
    err = reprojection_errors(Pb, x[..., None, :, :].expand(X0.shape[:-1] + (K, 2)), X0)  # (..., Q, K)
    inl = (err <= threshold_px) & mask[..., None, :] & (depths(Pb, X0) > 0)
    n_inl = torch.sum(inl, dim=-1)
    # the truncated total error breaks inlier-count ties
    tot = torch.sum(torch.clamp(err, max=threshold_px) * mask[..., None, :], dim=-1)
    score = n_inl.to(x.dtype) - tot / (threshold_px * K)
    score = torch.where(pair_ok, score, torch.full_like(score, -torch.inf))
    best = torch.argmax(score, dim=-1)
    X = torch.gather(X0, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    inliers = torch.gather(inl, -2, best[..., None, None].expand(best.shape + (1, K)))[..., 0, :]

    # local optimization: masked N-view refit on the inlier set
    for _ in range(lo_iters):
        Xr = triangulate_nview(P, x, mask=inliers)
        inl_r = (reprojection_errors(P, x, Xr) <= threshold_px) & mask & (depths(P, Xr) > 0)
        better = torch.sum(inl_r, dim=-1) >= torch.sum(inliers, dim=-1)
        X = torch.where(better[..., None], Xr, X)
        inliers = torch.where(better[..., None], inl_r, inliers)

    return X, inliers, torch.sum(inliers, dim=-1) >= 2
