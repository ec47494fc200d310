"""Epipolar-geometry solvers: F (7/8/10pt), E (8pt), H (4pt).

Port of `alicevision_tpu/multiview/epipolar.py` (ref:
src/aliceVision/multiview/relativePose/Fundamental7PSolver.hpp,
Fundamental8PSolver.hpp, Essential8PSolver.hpp, Homography4PSolver.hpp).
Every solver is closed-form batched linear algebra over fixed-size design
matrices, batched over leading dimensions (RANSAC's hypotheses): null
vectors from `torch.linalg.eigh` of AᵀA, rank projections from
`torch.linalg.svd`, the 7-point cubic in closed form. Eigen- and singular
vectors carry a sign (and F, H a scale) that differs between libraries;
every model is normalized as the reference normalizes it, and compares up
to sign.

Point conditioning (Hartley normalization) follows
src/aliceVision/robustEstimation/conditioning.cpp.
"""

from __future__ import annotations

import math

import torch

from ..geometry import Pose, pose_from_Rt
from ..numeric import cubic_roots_real, f32_matmuls
from .triangulation import triangulate_dlt

_EPS = 1e-12


def _where_small(x, eps=_EPS):
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


# ---------------------------------------------------------------------------
# Conditioning
# ---------------------------------------------------------------------------


def normalize_points(x: torch.Tensor, mask: torch.Tensor | None = None):
    """Hartley normalization: translate centroid to origin, scale mean norm to
    sqrt(2). x: (..., N, 2). Returns (x_norm, T) with T: (..., 3, 3)."""
    if mask is None:
        mean = torch.mean(x, dim=-2, keepdim=True)
        d = torch.linalg.norm(x - mean, dim=-1)
        scale = math.sqrt(2.0) / torch.mean(d, dim=-1).clamp(min=_EPS)
    else:
        w = mask.to(x.dtype)
        cnt = torch.sum(w, dim=-1, keepdim=True).clamp(min=1.0)
        mean = torch.sum(x * w[..., None], dim=-2, keepdim=True) / cnt[..., None]
        d = torch.linalg.norm(x - mean, dim=-1) * w
        scale = math.sqrt(2.0) * cnt[..., 0] / torch.sum(d, dim=-1).clamp(min=_EPS)
    s = scale[..., None, None]
    xn = (x - mean) * s
    zeros = torch.zeros_like(scale)
    ones = torch.ones_like(scale)
    T = torch.stack(
        [
            scale, zeros, -scale * mean[..., 0, 0],
            zeros, scale, -scale * mean[..., 0, 1],
            zeros, zeros, ones,
        ],
        dim=-1,
    ).reshape(x.shape[:-2] + (3, 3))
    return xn, T


def _epipolar_design(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Rows of the linear system x2^T F x1 = 0. x: (..., N, 2) -> (..., N, 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], dim=-1)


def _nullvectors(A: torch.Tensor, k: int) -> torch.Tensor:
    """k smallest right singular vectors of A (..., N, 9) -> (..., k, 9)."""
    AtA = A.transpose(-1, -2) @ A
    _, V = torch.linalg.eigh(AtA)
    return V[..., :, :k].transpose(-1, -2)


def _frobenius_normalize(F: torch.Tensor) -> torch.Tensor:
    return F / torch.linalg.norm(F, dim=(-2, -1), keepdim=True).clamp(min=_EPS)


@f32_matmuls
def fundamental_8pt(x1: torch.Tensor, x2: torch.Tensor, mask=None) -> torch.Tensor:
    """Normalized 8-point algorithm. x: (..., N>=8, 2) pixels -> F (..., 3, 3).

    Rank-2 constraint enforced by zeroing the smallest singular value.
    """
    x1n, T1 = normalize_points(x1, mask)
    x2n, T2 = normalize_points(x2, mask)
    A = _epipolar_design(x1n, x2n)
    if mask is not None:
        A = A * mask[..., None].to(A.dtype)
    f = _nullvectors(A, 1)[..., 0, :]
    F = f.reshape(f.shape[:-1] + (3, 3))
    # Rank-2 projection.
    U, s, Vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    F = U @ (s[..., :, None] * Vt)
    F = T2.transpose(-1, -2) @ F @ T1
    return _frobenius_normalize(F)


# The points t at which the cubic det(t F1 + (1 - t) F2) is sampled.
_TS = (0.0, 1.0, -1.0, 2.0)


@f32_matmuls
def fundamental_7pt(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """7-point solver: returns up to 3 solutions (..., 3, 3, 3).

    The cubic det(a F1 + (1-a) F2) = 0 is solved in closed form; complex
    roots are projected to their real part and produce duplicated/invalid F
    which RANSAC scoring naturally rejects.
    """
    x1n, T1 = normalize_points(x1)
    x2n, T2 = normalize_points(x2)
    A = _epipolar_design(x1n, x2n)
    fs = _nullvectors(A, 2)  # (..., 2, 9)
    F1 = fs[..., 0, :].reshape(fs.shape[:-2] + (3, 3))
    F2 = fs[..., 1, :].reshape(fs.shape[:-2] + (3, 3))

    # det(a F1 + (1 - a) F2) = c3 a^3 + c2 a^2 + c1 a + c0, evaluated at 4
    # points and interpolated.
    ts = torch.tensor(_TS, dtype=x1.dtype, device=x1.device)
    vals = torch.stack([torch.linalg.det(t * F1 + (1.0 - t) * F2) for t in _TS], dim=-1)
    V = torch.stack([ts**0, ts, ts**2, ts**3], dim=-1)  # (4, 4)
    coeffs = vals @ torch.linalg.inv(V).T
    c0, c1, c2, c3 = (coeffs[..., i] for i in range(4))

    a, _ = cubic_roots_real(c3, c2, c1, c0)  # (..., 3)

    Fs = a[..., None, None] * F1[..., None, :, :] + (1.0 - a)[..., None, None] * F2[..., None, :, :]
    Fs = T2.transpose(-1, -2)[..., None, :, :] @ Fs @ T1[..., None, :, :]
    return _frobenius_normalize(Fs)


@f32_matmuls
def essential_8pt(x1: torch.Tensor, x2: torch.Tensor, mask=None) -> torch.Tensor:
    """8-point essential from *normalized camera* coords; projects onto the
    essential manifold (two equal singular values)."""
    F = fundamental_8pt(x1, x2, mask)
    U, s, Vt = torch.linalg.svd(F)
    sm = 0.5 * (s[..., 0] + s[..., 1])
    s = torch.stack([sm, sm, torch.zeros_like(sm)], dim=-1)
    return U @ (s[..., :, None] * Vt)


def essential_from_F(F: torch.Tensor, K1: torch.Tensor, K2: torch.Tensor) -> torch.Tensor:
    return K2.transpose(-1, -2) @ F @ K1


@f32_matmuls
def homography_4pt(x1: torch.Tensor, x2: torch.Tensor, mask=None) -> torch.Tensor:
    """DLT homography from >= 4 correspondences. x: (..., N, 2) -> H (..., 3, 3)."""
    x1n, T1 = normalize_points(x1, mask)
    x2n, T2 = normalize_points(x2, mask)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    zero = torch.zeros_like(u1)
    one = torch.ones_like(u1)
    r1 = torch.stack([u1, v1, one, zero, zero, zero, -u2 * u1, -u2 * v1, -u2], dim=-1)
    r2 = torch.stack([zero, zero, zero, u1, v1, one, -v2 * u1, -v2 * v1, -v2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    if mask is not None:
        m2 = torch.cat([mask, mask], dim=-1).to(A.dtype)
        A = A * m2[..., None]
    h = _nullvectors(A, 1)[..., 0, :]
    H = h.reshape(h.shape[:-1] + (3, 3))
    H = torch.linalg.inv(T2) @ H @ T1
    return H / _where_small(H[..., 2:3, 2:3])


# ---------------------------------------------------------------------------
# Decomposition / residuals
# ---------------------------------------------------------------------------


@f32_matmuls
def decompose_essential(E: torch.Tensor):
    """E -> 4 candidate relative poses (R, t) with |t| = 1.

    Returns (R: (..., 4, 3, 3), t: (..., 4, 3)) — the classic U W V^T
    construction (ref: multiview/essential.cpp motionFromEssential).
    """
    U, _, Vt = torch.linalg.svd(E)
    # Enforce det(U) = det(V) = +1 so the candidates are rotations.
    dU = torch.linalg.det(U)
    dV = torch.linalg.det(Vt)
    one = torch.ones_like(dU)
    U = U * torch.stack([one, one, dU], -1)[..., None, :]
    Vt = Vt * torch.stack([one, one, dV], -1)[..., :, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[..., :, 2]
    R4 = torch.stack([Ra, Ra, Rb, Rb], dim=-3)
    t4 = torch.stack([t, -t, t, -t], dim=-2)
    return R4, t4


def select_cheirality(R4, t4, x1, x2, mask=None):
    """Pick the (R, t) candidate with the most points in front of both views.

    x1, x2: (..., N, 2) normalized-camera correspondences.
    Returns (R (...,3,3), t (...,3), n_front (...,)).
    """
    eye34 = torch.cat(
        [torch.eye(3, dtype=R4.dtype, device=R4.device), torch.zeros((3, 1), dtype=R4.dtype, device=R4.device)], -1
    )
    P1 = eye34.expand(R4.shape[:-3] + (3, 4))

    def count_front(R, t):
        P2 = torch.cat([R, t[..., :, None]], dim=-1)
        X = triangulate_dlt(P1[..., None, :, :], P2[..., None, :, :], x1, x2)  # (..., N, 3)
        z1 = X[..., 2]
        Xc2 = X @ R.transpose(-1, -2) + t[..., None, :]
        z2 = Xc2[..., 2]
        ok = (z1 > 0) & (z2 > 0)
        if mask is not None:
            ok = ok & mask
        return torch.sum(ok, dim=-1)

    counts = torch.stack([count_front(R4[..., i, :, :], t4[..., i, :]) for i in range(4)], dim=-1)
    best = torch.argmax(counts, dim=-1)
    R = torch.gather(R4, -3, best[..., None, None, None].expand(best.shape + (1, 3, 3)))[..., 0, :, :]
    t = torch.gather(t4, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    return R, t, torch.amax(counts, dim=-1)


@f32_matmuls
def relative_pose_from_essential(E, x1, x2, mask=None) -> Pose:
    R4, t4 = decompose_essential(E)
    R, t, _ = select_cheirality(R4, t4, x1, x2, mask)
    return pose_from_Rt(R, t)


@f32_matmuls
def epipolar_distance_sq(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Symmetric squared epipolar (Sampson) distance.

    F: (..., 3, 3), x: (..., N, 2) -> (..., N). This is the residual used for
    RANSAC scoring (matches the reference's errorEstimator choices).
    """
    ones = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, ones], dim=-1)  # (..., N, 3)
    p2 = torch.cat([x2, ones], dim=-1)
    Fp1 = p1 @ F.transpose(-1, -2)  # rows F p1
    Ftp2 = p2 @ F  # rows F^T p2
    num = torch.sum(p2 * Fp1, dim=-1) ** 2
    den = (Fp1[..., 0] ** 2 + Fp1[..., 1] ** 2 + Ftp2[..., 0] ** 2 + Ftp2[..., 1] ** 2).clamp(min=_EPS)
    return num / den


@f32_matmuls
def homography_error_sq(H: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Forward transfer squared error ||H x1 - x2||^2 -> (..., N)."""
    ones = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, ones], dim=-1)
    Hp = p1 @ H.transpose(-1, -2)
    uv = Hp[..., :2] / _where_small(Hp[..., 2:])
    return torch.sum((uv - x2) ** 2, dim=-1)


@f32_matmuls
def fundamental_10pt(
    x1: torch.Tensor,
    x2: torch.Tensor,
    mask: torch.Tensor | None = None,
    n_lambda: int = 33,
    refine_rounds: int = 3,
):
    """F + one shared radial distortion coefficient from >= 10 pixel
    correspondences (division model applied symmetrically to both views).

    The reference's F10 Gröbner solver (ref:
    src/aliceVision/multiview/relativePose/Fundamental10PSolver.hpp:37)
    becomes a fixed lambda sweep: each λ undistorts both sides
    (x_u = x_d / (1 + λ r̂²), radius normalized by the pair's spread), the
    8-point solve scores it by total Sampson error, and shrinking grids
    refine λ around the winner.

    x1, x2: (..., N>=10, 2) *centered* pixels (principal point at origin).
    Returns (F (..., 3, 3), lam (...,)) where the model is
    x2u^T F x1u = 0 with x_u = x / (1 + lam * |x|^2 / s^2), s the mean
    point radius of the pair.
    """
    dt = x1.dtype
    dev = x1.device
    if mask is None:
        mask = torch.ones(x1.shape[:-1], dtype=torch.bool, device=dev)
    w = mask.to(dt)
    cnt = torch.sum(w, -1, keepdim=True).clamp(min=1.0)
    s2 = (
        torch.sum((torch.sum(x1 * x1, -1) + torch.sum(x2 * x2, -1)) * w, -1, keepdim=True)
        / (2.0 * cnt)
    ).clamp(min=_EPS)  # (..., 1) mean squared radius

    def undistort(x, lam):
        # lam: (..., K) broadcast over points; x: (..., N, 2)
        r2 = torch.sum(x * x, -1) / s2  # (..., N)
        d = 1.0 + lam[..., None] * r2[..., None, :]  # (..., K, N)
        d = torch.where(torch.abs(d) < 0.05, torch.full_like(d, 0.05), d)
        return x[..., None, :, :] / d[..., None]

    def score(lam):
        u1 = undistort(x1, lam)
        u2 = undistort(x2, lam)
        F = fundamental_8pt(u1, u2, mask=mask[..., None, :].expand(u1.shape[:-1]))
        res = epipolar_distance_sq(F, u1, u2)
        return F, torch.sum(res * w[..., None, :], -1)

    lo = torch.full(x1.shape[:-2], -0.5, dtype=dt, device=dev)
    hi = torch.full(x1.shape[:-2], 0.5, dtype=dt, device=dev)
    grid = torch.linspace(0.0, 1.0, n_lambda, dtype=dt, device=dev)
    best_F = None
    best_lam = None
    for _ in range(refine_rounds):
        lam = lo[..., None] + (hi - lo)[..., None] * grid
        F, sc = score(lam)
        i = torch.argmin(sc, dim=-1)
        best_lam = torch.gather(lam, -1, i[..., None])[..., 0]
        best_F = torch.gather(F, -3, i[..., None, None, None].expand(i.shape + (1, 3, 3)))[..., 0, :, :]
        step = (hi - lo) / (n_lambda - 1)
        lo = best_lam - step
        hi = best_lam + step
    return best_F, best_lam / s2[..., 0]
