"""Homography-growing match filter ([F.Srajer 2016] algo. 1).

Port of `alicevision_tpu/matching/hgrowing.py`, the redesign of the
reference's ``filterMatchesByHGrowing``
(ref: src/aliceVision/matchingImageCollection/GeometricFilterMatrix_HGrowing.hpp:23-121,
GeometricFilterMatrix_HGrowing.cpp:62-190, geometricFilterUtils.cpp:94-117):
every seed grows its homography at once, as a batch axis. The 8 refinement
iterations are a Python loop over batched solves (iteration 0: similarity
from the seed's position/scale/orientation; iterations 1-4: affinity by
masked least squares; 5+: homography by masked normalized DLT). Plane
extraction is then a deterministic greedy set cover over the per-seed
inlier masks, on the host.

The DLT's 9x9 normal matrix is decomposed in float32 LAPACK on the CPU, as
the JAX package does, and formed and decomposed in float64 on a card, whose
batched float32 eigh loses the smallest eigenvector of such matrices
(`numeric.eigh64`).

Defaults mirror GrowParameters / HGrowingFilteringParam
(GeometricFilterMatrix_HGrowing.hpp:44-106): tolerances 20/10/5 px,
min 6 inliers to refine, 8 refining iterations, max 10 homographies,
min 20 matches per homography.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..numeric import eigh, f32_matmuls

__all__ = ["HGrowingParams", "grow_from_seeds", "filter_matches_hgrowing"]


class HGrowingParams(NamedTuple):
    similarity_tolerance: float = 20.0
    affinity_tolerance: float = 10.0
    homography_tolerance: float = 5.0
    min_inliers_to_refine: int = 6
    nb_refining_iterations: int = 8
    max_nb_homographies: int = 10
    min_nb_matches_per_h: int = 20
    max_seeds: int = 256


def _frame(xy, s, o):
    """(S, 3, 3) frames [[s c, -s s, x], [s s, s c, y], [0, 0, 1]]."""
    c, sn = torch.cos(o), torch.sin(o)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([
        torch.stack([s * c, -s * sn, xy[:, 0]], -1),
        torch.stack([s * sn, s * c, xy[:, 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)


def _similarity_from_seed(xy1, scale1, ori1, xy2, scale2, ori2):
    """S = A2 @ A1^-1 per seed (ref: geometricFilterUtils.cpp:94-117,
    computeSimilarity)."""
    return _frame(xy2, scale2, ori2) @ torch.linalg.inv(_frame(xy1, scale1, ori1))


def _transfer_err2(H, pI, pJ):
    """Squared Euclidean transfer error |dehom(H pI) - pJ|^2 of every match
    under each seed's H (S, 3, 3): (S, N)."""
    ph = pI @ H[:, :, :2].transpose(-1, -2) + H[:, None, :, 2]
    w = torch.where(ph[..., 2].abs() < 1e-12, torch.full_like(ph[..., 2], 1e-12), ph[..., 2])
    proj = ph[..., :2] / w[..., None]
    return ((proj - pJ) ** 2).sum(-1)


def _estimate_affinity(pI, pJ, w):
    """Masked least-squares affinity per seed, w (S, N)
    (ref: geometricFilterUtils estimateAffinity). x' and y' rows decouple:
    both solve the same 3x3 normal system X^T W X p = X^T W x'."""
    n = w.sum(-1).clamp(min=1.0)
    X = torch.cat([pI, torch.ones_like(pI[:, :1])], dim=1)  # (N, 3)
    Xw = X * w[..., None]  # (S, N, 3)
    eye = torch.eye(3, dtype=pI.dtype, device=pI.device)
    G = X.T @ Xw + 1e-6 * eye * n[:, None, None]
    rhs = Xw.transpose(-1, -2) @ pJ  # (S, 3, 2)
    sol = torch.linalg.solve(G, rhs)  # rows of A^T
    H = eye.expand(w.shape[0], 3, 3).clone()
    H[:, 0, :] = sol[..., 0]
    H[:, 1, :] = sol[..., 1]
    return H


def _dlt_nullvector64(Araw, A):
    """`_dlt_nullvector` with the normal matrix formed and decomposed in
    float64, returned in A's dtype."""
    G = Araw.double().transpose(-1, -2) @ A.double()
    _, vecs = eigh(G + 1e-9 * torch.eye(9, dtype=G.dtype, device=G.device))
    return vecs[..., :, 0].to(A.dtype)


def _dlt_nullvector(Araw, A):
    """Eigenvector of the smallest eigenvalue of Arawᵀ A + 1e-9 I (9x9 per
    seed): float32 LAPACK on the CPU, as the JAX package takes it; float64
    on a card (`_dlt_nullvector64`)."""
    if A.is_cuda:
        return _dlt_nullvector64(Araw, A)
    _, vecs = eigh(Araw.transpose(-1, -2) @ A + 1e-9 * torch.eye(9, dtype=A.dtype, device=A.device))
    return vecs[..., :, 0]


def _estimate_homography(pI, pJ, w):
    """Masked normalized DLT per seed; smallest eigenvector of A^T W A
    (9x9)."""
    n = w.sum(-1).clamp(min=1.0)

    def normalize(p):
        mean = (p * w[..., None]).sum(-2) / n[:, None]  # (S, 2)
        d = torch.sqrt(((p - mean[:, None]) ** 2).sum(-1) + 1e-12)
        s = math.sqrt(2.0) / ((d * w).sum(-1) / n).clamp(min=1e-9)
        zero, one = torch.zeros_like(s), torch.ones_like(s)
        T = torch.stack([
            torch.stack([s, zero, -s * mean[:, 0]], -1),
            torch.stack([zero, s, -s * mean[:, 1]], -1),
            torch.stack([zero, zero, one], -1),
        ], -2)
        return (p - mean[:, None]) * s[:, None, None], T

    qI, TI = normalize(pI)
    qJ, TJ = normalize(pJ)
    x, y = qI[..., 0], qI[..., 1]
    u, v = qJ[..., 0], qJ[..., 1]
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)  # (S, N, 9)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    Araw = torch.cat([r1, r2], dim=-2)
    h = _dlt_nullvector(Araw, A).reshape(-1, 3, 3)
    H = torch.linalg.inv(TJ) @ h @ TI
    h22 = H[:, 2, 2]
    return H / torch.where(h22.abs() < 1e-12, torch.full_like(h22, 1e-12), h22)[:, None, None]


@f32_matmuls
def grow_from_seeds(
    pI: torch.Tensor,
    pJ: torch.Tensor,
    scaleI: torch.Tensor,
    scaleJ: torch.Tensor,
    oriI: torch.Tensor,
    oriJ: torch.Tensor,
    valid: torch.Tensor,
    seed_ids: torch.Tensor,
    params: HGrowingParams = HGrowingParams(),
):
    """Grow one homography per seed, all seeds at once.

    Args:
      pI, pJ: (N, 2) matched keypoint positions in view I / J.
      scaleI..oriJ: (N,) per-match keypoint scale / orientation.
      valid: (N,) bool mask of matches still in play.
      seed_ids: (S,) indices into the match arrays.

    Returns:
      H: (S, 3, 3) grown homographies, inliers: (S, N) bool, count: (S,).
    """
    p = params
    sid = seed_ids.long()
    H = _similarity_from_seed(pI[sid], scaleI[sid], oriI[sid], pJ[sid], scaleJ[sid], oriJ[sid])
    inl = (_transfer_err2(H, pI, pJ) < p.similarity_tolerance**2) & valid
    for step in range(1, p.nb_refining_iterations):
        w = inl.to(pI.dtype)
        enough = inl.sum(-1) >= p.min_inliers_to_refine
        if step <= 4:
            Hn = _estimate_affinity(pI, pJ, w)
            tol = p.affinity_tolerance
        else:
            Hn = _estimate_homography(pI, pJ, w)
            tol = p.homography_tolerance
        H = torch.where(enough[:, None, None], Hn, H)
        inl = (_transfer_err2(H, pI, pJ) < tol**2) & valid
    return H, inl, inl.sum(-1)


def filter_matches_hgrowing(
    xyI: np.ndarray,
    xyJ: np.ndarray,
    scaleI: np.ndarray,
    scaleJ: np.ndarray,
    oriI: np.ndarray,
    oriJ: np.ndarray,
    params: HGrowingParams = HGrowingParams(),
    device="cuda",
):
    """Full HGrowing filter for one image pair.

    ref: filterMatchesByHGrowing (GeometricFilterMatrix_HGrowing.cpp:107-190).
    Greedy plane extraction over the precomputed per-seed inlier masks
    replaces the reference's per-round regrow; each selected plane claims
    its inliers and later picks are scored on the shrinking remainder.

    Returns (homographies (K,3,3) float ndarray, assignment (N,) int32 with
    plane id or -1, inlier_mask (N,) bool).
    """
    dev = resolve_device(device)
    n = xyI.shape[0]
    p = params
    if n < p.min_inliers_to_refine:
        return (
            np.zeros((0, 3, 3), np.float32),
            np.full(n, -1, np.int32),
            np.zeros(n, bool),
        )

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    s = min(n, p.max_seeds)
    seed_ids = torch.as_tensor(np.round(np.linspace(0, n - 1, s)).astype(np.int64), device=dev)
    H, inl, _ = grow_from_seeds(
        f32(xyI), f32(xyJ), f32(scaleI), f32(scaleJ), f32(oriI), f32(oriJ),
        torch.ones(n, dtype=torch.bool, device=dev), seed_ids, params,
    )
    H = H.cpu().numpy()
    inl = inl.cpu().numpy()

    remaining = np.ones(n, bool)
    assignment = np.full(n, -1, np.int32)
    homs = []
    for k in range(p.max_nb_homographies):
        scores = (inl & remaining).sum(axis=1)
        best = int(scores.argmax())
        if scores[best] < p.min_nb_matches_per_h:
            break
        sel = inl[best] & remaining
        assignment[sel] = k
        homs.append(H[best])
        remaining &= ~sel
        if remaining.sum() < p.min_nb_matches_per_h:
            break
    homs = np.stack(homs) if homs else np.zeros((0, 3, 3), np.float32)
    return homs, assignment, assignment >= 0
