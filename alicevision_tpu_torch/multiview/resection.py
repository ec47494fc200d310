"""Absolute-pose (resection) solvers: P3P, Kabsch, the Gauss-Newton pose
refinement, the 6-point DLT, EPnP, and P4Pf / P5Pfr with unknown focal
(and radial distortion).

Port of `alicevision_tpu/multiview/resection.py` (ref:
src/aliceVision/multiview/resection/P3PSolver.hpp:19, EPnPSolver.hpp,
Resection6PSolver.hpp, P4PfSolver.hpp:21, P5PfrSolver.hpp:26). P3P is Grunert's
formulation [Haralick et al., IJCV 1994]: the two depth-ratio quadratics'
resultant, a quartic in v, is sampled at five abscissae and interpolated
through a fixed Vandermonde inverse (computed once, here in float64), then
rooted with the closed-form Ferrari solver; up to 4 candidate poses a
sample, with a validity mask. The Gauss-Newton refinements (pose, and pose + log focal [+ k1]) take
closed-form Jacobians where the reference takes `jax.jvp` columns. P4Pf
and P5Pfr sweep a fixed focal (x k1) grid through P3P on points 0-2, rank
the candidates by the other points' reprojection and polish the best
`top_k`; `torch.topk` may order tied scores differently from
`lax.top_k`, so compare their candidates as sets.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..geometry.rotations import hat, so3_exp
from ..numeric import eigh64, f32_matmuls, quartic_roots_real, svd

_EPS = 1e-12

# abscissae of the resultant samples and the inverse of their Vandermonde
# matrix: coefficients c0..c4 = _VINV @ values
_TS = (0.0, 1.0, -1.0, 2.0, -2.0)
_VINV = np.linalg.inv(np.array([[t**i for i in range(5)] for t in _TS], np.float64))


@f32_matmuls
def kabsch(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor | None = None):
    """Rigid transform (R, t) minimizing ||R @ src + t - dst||^2.
    src, dst: (..., N, 3). Returns R (..., 3, 3), t (..., 3)."""
    w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device) if mask is None else mask.to(src.dtype)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=_EPS)
    mu_s = torch.sum(src * w[..., None], dim=-2) / wsum
    mu_d = torch.sum(dst * w[..., None], dim=-2) / wsum
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    H = (dc * w[..., None]).transpose(-1, -2) @ sc
    U, _, Vt = svd(H)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    R = U @ (torch.stack([one, one, det], dim=-1)[..., :, None] * Vt)
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return R, t


@f32_matmuls
def p3p(world: torch.Tensor, bearings: torch.Tensor):
    """Grunert P3P. world: (..., 3, 3) points, bearings: (..., 3, 3) unit
    rays in the camera frame. Returns (R (..., 4, 3, 3), t (..., 4, 3),
    valid (..., 4)) — candidate poses with x_cam = R x_world + t."""
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    P1, P2, P3 = world[..., 0, :], world[..., 1, :], world[..., 2, :]

    cos_a = torch.sum(f2 * f3, dim=-1)  # angle opposite side a = |P2 P3|
    cos_b = torch.sum(f1 * f3, dim=-1)
    cos_g = torch.sum(f1 * f2, dim=-1)
    a2 = torch.sum((P2 - P3) ** 2, dim=-1)
    b2 = torch.sum((P1 - P3) ** 2, dim=-1)
    c2 = torch.sum((P1 - P2) ** 2, dim=-1)

    # With s2 = u s1, s3 = v s1:
    #  (1)/(2): 1 + u^2 - 2 u cos_g = (c2/b2)(1 + v^2 - 2 v cos_b)
    #  (3)/(2): (u^2 + v^2 - 2 u v cos_a) b2 = a2 (1 + v^2 - 2 v cos_b)
    def quad_coeffs(v):
        # v may carry a trailing candidate dimension
        e = (lambda x: x[..., None]) if v.dim() == cos_a.dim() + 1 else (lambda x: x)
        ca, cb, cg = e(cos_a), e(cos_b), e(cos_g)
        A2, B2, C2 = e(a2), e(b2), e(c2)
        k = (C2 / torch.clamp(B2, min=_EPS)) * (1.0 + v * v - 2.0 * v * cb)
        ones = torch.ones_like(v)
        first = (ones, -2.0 * cg * ones, 1.0 - k)
        second = (B2.expand(v.shape), -2.0 * B2 * v * ca, B2 * v * v - A2 * (1.0 + v * v - 2.0 * v * cb))
        return first, second

    def resultant(v):
        (a1q, b1q, c1q), (a2q, b2q, c2q) = quad_coeffs(v)
        return (a1q * c2q - a2q * c1q) ** 2 - (a1q * b2q - a2q * b1q) * (b1q * c2q - b2q * c1q)

    # the resultant is a quartic in v: 5 samples, interpolated
    vals = torch.stack([resultant(torch.full_like(cos_a, t)) for t in _TS], dim=-1)
    coeffs = vals @ torch.as_tensor(_VINV.T, dtype=world.dtype, device=world.device)  # c0..c4
    v_roots, v_valid = quartic_roots_real(
        coeffs[..., 4], coeffs[..., 3], coeffs[..., 2], coeffs[..., 1], coeffs[..., 0]
    )  # (..., 4)

    # u for each v: the shared root of the two quadratics
    (a1q, b1q, c1q), (a2q, b2q, c2q) = quad_coeffs(v_roots)
    den = a2q * b1q - a1q * b2q
    u = (a1q * c2q - a2q * c1q) / torch.where(torch.abs(den) < _EPS, torch.full_like(den, _EPS), den)

    s1sq = c2[..., None] / torch.clamp(1.0 + u * u - 2.0 * u * cos_g[..., None], min=_EPS)
    s1 = torch.sqrt(torch.clamp(s1sq, min=0.0))
    s2 = u * s1
    s3 = v_roots * s1
    # depth positivity is checked after the polish (z > 0 below)
    Xc = torch.stack(
        [s1[..., None] * f1[..., None, :], s2[..., None] * f2[..., None, :], s3[..., None] * f3[..., None, :]],
        dim=-2,
    )  # (..., 4 candidates, 3 points, 3)
    Pw = world[..., None, :, :].expand(Xc.shape)
    R, t = kabsch(Pw, Xc)  # world -> camera

    # Gauss-Newton on the minimal set: float32 quartic roots are ~1e-3
    # accurate, the polish restores machine precision
    obs_norm = bearings[..., :2] / torch.clamp(bearings[..., 2:], min=1e-6)  # (..., 3, 2)
    obs_b = obs_norm[..., None, :, :].expand(Xc.shape[:-1] + (2,))
    R = torch.where(torch.isfinite(R), R, torch.eye(3, dtype=R.dtype, device=R.device))
    t = torch.where(torch.isfinite(t), t, torch.zeros_like(t))
    R, t = gauss_newton_pose_refine(R, t, Pw, obs_b, iters=5)

    # exact solutions reproject the minimal set to ~0 with positive depths
    fit = Pw @ R.transpose(-1, -2) + t[..., None, :]
    z = fit[..., 2]
    uv = fit[..., :2] / torch.clamp(z[..., None], min=1e-6)
    rep = torch.amax(torch.linalg.norm(uv - obs_b, dim=-1), dim=-1)
    valid = v_valid & (rep < 3e-3) & torch.all(z > 0, dim=-1) & torch.isfinite(rep)
    return R, t, valid


@f32_matmuls
def gauss_newton_pose_refine(
    R: torch.Tensor,
    t: torch.Tensor,
    world: torch.Tensor,
    obs_norm: torch.Tensor,
    mask: torch.Tensor | None = None,
    iters: int = 5,
):
    """Refine (R, t) by Gauss-Newton on normalized-plane reprojection,
    `iters` fixed steps, the 6x6 normal equations solved densely.
    world: (..., N, 3), obs_norm: (..., N, 2). The update is
    R <- exp(dw) R, t <- t + dt, so the residual's Jacobian at dx = 0 is
    d(x/z)/dX_c · [-[R X]_x | I], with the depth clamp's derivative."""
    w = torch.ones(world.shape[:-1], dtype=world.dtype, device=world.device) if mask is None else mask.to(world.dtype)
    eye6 = torch.eye(6, dtype=world.dtype, device=world.device)
    for _ in range(iters):
        uv, _, J = _normalized_plane_jacobian(R, t, world)
        r = (uv - obs_norm) * w[..., None]  # (..., N, 2)
        J = (J * w[..., None, None]).flatten(-3, -2)  # (..., 2N, 6)
        JtJ = J.transpose(-1, -2) @ J + 1e-8 * eye6
        Jtr = J.transpose(-1, -2) @ r.reshape(r.shape[:-2] + (-1, 1))
        dx = -torch.linalg.solve_ex(JtJ, Jtr)[0][..., 0]
        R = so3_exp(dx[..., :3]) @ R
        t = t + dx[..., 3:]
    return R, t


@f32_matmuls
def resection_dlt6(world: torch.Tensor, obs_norm: torch.Tensor, mask: torch.Tensor | None = None):
    """6-point (or more) DLT resection on the normalized image plane
    (Resection6PSolver): the smallest right singular vector of the 2N x 12
    system (eigh of AᵀA, in float64) gives P = [R | t] up to scale; R is projected onto
    SO(3) by SVD, the sign and scale fixed from the depths and the singular
    values, then 5 Gauss-Newton steps. world: (..., N, 3), obs_norm:
    (..., N, 2). Returns (R, t, valid) with x_cam = R x_world + t."""
    w = torch.ones(world.shape[:-1], dtype=world.dtype, device=world.device) if mask is None else mask.to(world.dtype)
    X = torch.cat([world, torch.ones_like(world[..., :1])], dim=-1)  # (..., N, 4)
    u, v = obs_norm[..., 0:1], obs_norm[..., 1:2]
    zeros = torch.zeros_like(X)
    row_u = torch.cat([X, zeros, -u * X], dim=-1)  # (..., N, 12)
    row_v = torch.cat([zeros, X, -v * X], dim=-1)
    A = torch.cat([row_u, row_v], dim=-2) * torch.cat([w, w], dim=-1)[..., None]
    _, eigvec = eigh64(A.transpose(-1, -2) @ A)
    p = eigvec[..., :, 0]  # (..., 12)
    P = p.reshape(p.shape[:-1] + (3, 4))
    Rraw, t = P[..., :3], P[..., 3]
    # the sign that makes the (masked) mean depth positive, then the scale
    z = (world @ Rraw[..., 2, :, None])[..., 0] + t[..., 2:3]
    sign = torch.where(torch.sum(z * w, dim=-1, keepdim=True) < 0, -1.0, 1.0)
    Rraw = Rraw * sign[..., None]
    t = t * sign
    U, S, Vt = svd(Rraw)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    R = U @ (torch.stack([one, one, det], dim=-1)[..., :, None] * Vt)
    scale = torch.mean(S, dim=-1) * torch.where(det < 0, -1.0, 1.0)
    t = t / torch.where(torch.abs(scale) < _EPS, torch.full_like(scale, _EPS), scale)[..., None]
    R, t = gauss_newton_pose_refine(R, t, world, obs_norm, mask=mask, iters=5)
    zf = (world @ R[..., 2, :, None])[..., 0] + t[..., None, 2]
    ok_depth = torch.all((zf > 0) | (w == 0), dim=-1)
    finite = torch.isfinite(R).flatten(-2).all(-1) & torch.isfinite(t).all(-1)
    return R, t, ok_depth & finite


def _pairwise_dists(pts4: torch.Tensor) -> torch.Tensor:
    """Squared distances between the 6 pairs of 4 points. pts4: (..., 4, 3)."""
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    return torch.stack([torch.sum((pts4[..., i, :] - pts4[..., j, :]) ** 2, dim=-1) for i, j in pairs], dim=-1)


@f32_matmuls
def epnp(world: torch.Tensor, obs_norm: torch.Tensor, mask: torch.Tensor | None = None):
    """EPnP [Lepetit et al., IJCV 2009] for N >= 4 points (EPnPSolver).
    Control points are the centroid and the principal axes of the world
    points; the camera-frame control points come from the two smallest
    eigenvectors of the 12x12 normal matrix, each scaled by the closed-form
    N = 1 beta, and the better by reprojection after Kabsch and 5
    Gauss-Newton steps wins. world: (..., N, 3), obs_norm: (..., N, 2).
    Returns (R, t, valid)."""
    w = torch.ones(world.shape[:-1], dtype=world.dtype, device=world.device) if mask is None else mask.to(world.dtype)
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=_EPS)
    c0 = torch.sum(world * wn[..., None], dim=-2)  # centroid (..., 3)
    Xc = (world - c0[..., None, :]) * torch.sqrt(wn)[..., None]
    eval_, evec = eigh64(Xc.transpose(-1, -2) @ Xc)  # ascending
    axes = evec * torch.sqrt(torch.clamp(eval_, min=1e-10))[..., None, :]  # columns
    ctrl = torch.cat([c0[..., None, :], c0[..., None, :] + axes.transpose(-1, -2)], dim=-2)  # (..., 4, 3)
    # barycentric coordinates: alphas solve ctrlᵀ alpha = [X; 1]
    Ct = torch.cat([ctrl.transpose(-1, -2), torch.ones_like(ctrl[..., None, :, 0])], dim=-2)  # (..., 4, 4)
    Xh = torch.cat([world, torch.ones_like(world[..., :1])], dim=-1)  # (..., N, 4)
    alphas = Xh @ torch.linalg.inv(Ct).transpose(-1, -2)  # (..., N, 4)
    u, v = obs_norm[..., 0], obs_norm[..., 1]
    zero, one = torch.zeros_like(u), torch.ones_like(u)
    ru = torch.stack([one, zero, -u], dim=-1)  # (..., N, 3)
    rv = torch.stack([zero, one, -v], dim=-1)
    Mu = (alphas[..., :, None] * ru[..., None, :]).flatten(-2) * w[..., None]  # (..., N, 12)
    Mv = (alphas[..., :, None] * rv[..., None, :]).flatten(-2) * w[..., None]
    M = torch.cat([Mu, Mv], dim=-2)  # (..., 2N, 12)
    _, V = eigh64(M.transpose(-1, -2) @ M)
    d_world = _pairwise_dists(ctrl)  # (..., 6)

    def beta_case1(vcol):
        # squared distances: d_cam scales as beta^2
        d_cam = _pairwise_dists(vcol.reshape(vcol.shape[:-1] + (4, 3)))
        beta2 = torch.sum(d_cam * d_world, dim=-1) / torch.clamp(torch.sum(d_cam * d_cam, dim=-1), min=_EPS)
        return torch.sqrt(torch.clamp(beta2, min=0.0))[..., None] * vcol

    mask_b = w > 0
    Rs, ts, errs = [], [], []
    for x in (beta_case1(V[..., :, 0]), beta_case1(V[..., :, 1])):
        cc = x.reshape(x.shape[:-1] + (4, 3))
        pts_cam = alphas @ cc  # (..., N, 3)
        sgn = torch.where(torch.sum(pts_cam[..., 2] * w, dim=-1, keepdim=True) < 0, -1.0, 1.0)
        pts_cam = pts_cam * sgn[..., None]
        R, t = kabsch(world, pts_cam, mask=mask_b)
        R, t = gauss_newton_pose_refine(R, t, world, obs_norm, mask=mask_b, iters=5)
        pc = world @ R.transpose(-1, -2) + t[..., None, :]
        z = torch.clamp(pc[..., 2:], min=1e-6)
        errs.append(torch.sum(torch.sum((pc[..., :2] / z - obs_norm) ** 2, dim=-1) * w, dim=-1))
        Rs.append(R)
        ts.append(t)
    first = torch.argmin(torch.stack(errs, dim=-1), dim=-1) == 0
    R = torch.where(first[..., None, None], Rs[0], Rs[1])
    t = torch.where(first[..., None], ts[0], ts[1])
    zf = (world @ R[..., 2, :, None])[..., 0] + t[..., None, 2]
    valid = (
        torch.all((zf > 0) | (w == 0), dim=-1)
        & torch.isfinite(R).flatten(-2).all(-1)
        & torch.isfinite(t).all(-1)
    )
    return R, t, valid


def _normalized_plane_jacobian(R, t, world):
    """(uv (..., N, 2), the depth-clamped z (..., N), d uv / d(dw, dt)
    (..., N, 2, 6)) at R <- exp(dw) R, t <- t + dt, dx = 0."""
    RX = world @ R.transpose(-1, -2)
    Xc = RX + t[..., None, :]
    zr = Xc[..., 2]
    z = torch.clamp(zr, min=1e-6)
    uv = Xc[..., :2] / z[..., None]
    dz = (zr > 1e-6).to(world.dtype) / z  # 0 where the depth is clamped
    zero, inv_z = torch.zeros_like(z), 1.0 / z
    dproj = torch.stack(
        [torch.stack([inv_z, zero, -uv[..., 0] * dz], -1), torch.stack([zero, inv_z, -uv[..., 1] * dz], -1)],
        dim=-2,
    )  # (..., N, 2, 3)
    eye3 = torch.eye(3, dtype=world.dtype, device=world.device)
    return uv, z, dproj @ torch.cat([-hat(RX), eye3.expand(RX.shape + (3,))], dim=-1)


@f32_matmuls
def _pose_focal_refine(R, t, logf, world, obs_px, k1=None, iters: int = 8):
    """Joint Gauss-Newton over (so3, t, log focal[, k1]) on the pixel-domain
    reprojection of the minimal set, batched over candidates; the 7x7 (8x8)
    normal equations solved densely. k1 is the division-model coefficient
    applied to the observations: x_u = x_d / (1 + k1 |x_d / f|^2). The
    residual is proj - x_u; its focal and k1 columns are closed-form:
    d/d log f = x_u (1 - 2 k1 s / D) and d/d k1 = x_u s / D, with
    x_n = obs / f, s = |x_n|^2, D = 1 + k1 s."""
    with_k1 = k1 is not None
    nparam = 8 if with_k1 else 7
    if not with_k1:
        k1 = torch.zeros_like(logf)
    eye = torch.eye(nparam, dtype=world.dtype, device=world.device)
    for _ in range(iters):
        uv, _, Jpose = _normalized_plane_jacobian(R, t, world)
        xn = obs_px / torch.exp(logf)[..., None, None]
        s = torch.sum(xn * xn, dim=-1, keepdim=True)
        D = 1.0 + k1[..., None, None] * s
        und = xn / D
        r = (uv - und).flatten(-2)  # (..., 2N)
        cols = [Jpose, (und * (1.0 - 2.0 * k1[..., None, None] * s / D))[..., None]]
        if with_k1:
            cols.append((und * s / D)[..., None])
        J = torch.cat(cols, dim=-1).flatten(-3, -2)  # (..., 2N, nparam)
        JtJ = J.transpose(-1, -2) @ J + 1e-8 * eye
        dx = -torch.linalg.solve_ex(JtJ, (J.transpose(-1, -2) @ r[..., None]))[0][..., 0]
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
        R = so3_exp(dx[..., :3]) @ R
        t = t + dx[..., 3:6]
        logf = torch.minimum(torch.maximum(logf + dx[..., 6], logf - 2.0), logf + 2.0)
        if with_k1:
            k1 = k1 + dx[..., 7]
    return R, t, logf, k1


def _score_sweep(R, t, valid, world, obs_n, f_grid, obs_px=None):
    """Candidates of a focal sweep scored by the pixel reprojection of all
    points: the largest error, +inf where invalid or behind the camera.
    R (..., F, 4, 3, 3), obs_n (..., F, N, 2) normalized at each focal;
    with obs_px (..., N, 2) the error is taken in pixels as |f proj - obs|
    (the reference's order of operations for P4Pf). Returns the
    (F * 4)-flattened (R, t, log f, score)."""
    F, N = f_grid.shape[0], world.shape[-2]
    wN = world[..., None, None, :, :].expand(R.shape[:-2] + (N, 3))
    Xc = wN @ R.transpose(-1, -2) + t[..., None, :]
    proj = Xc[..., :2] / torch.clamp(Xc[..., 2:], min=1e-6)
    if obs_px is None:
        err = torch.linalg.norm(proj - obs_n[..., None, :, :], dim=-1) * f_grid[:, None, None]
    else:
        err = torch.linalg.norm(proj * f_grid[:, None, None, None] - obs_px[..., None, None, :, :], dim=-1)
    score = torch.amax(err, dim=-1) + torch.where(valid, 0.0, math.inf)
    score = torch.where(torch.all(Xc[..., 2] > 0, dim=-1), score, torch.full_like(score, math.inf))
    bs = R.shape[:-4]
    lf = torch.log(f_grid)[:, None].expand(bs + (F, 4)).reshape(bs + (F * 4,))
    return R.reshape(bs + (F * 4, 3, 3)), t.reshape(bs + (F * 4, 3)), lf, score.reshape(bs + (F * 4,))


def _p3p_on_first_three(world, obs_n):
    """P3P on points 0-2 of each focal's normalized observations
    obs_n (..., F, N, 2)."""
    rays = torch.cat([obs_n, torch.ones_like(obs_n[..., :1])], dim=-1)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    w3 = world[..., None, :3, :].expand(obs_n.shape[:-2] + (3, 3))
    return p3p(w3, rays[..., :3, :])


def _p3p_focal_sweep(world, obs_px, f_grid):
    """P3P on points 0-2 over a batch of focal hypotheses, scored by all
    points' reprojection. world (..., N, 3), obs_px (..., N, 2) centred
    pixels, f_grid (F,). -> (R, t, log f, score) over F * 4 candidates."""
    xn = obs_px[..., None, :, :] / f_grid[:, None, None]  # (..., F, N, 2)
    R, t, valid = _p3p_on_first_three(world, xn)
    return _score_sweep(R, t, valid, world, xn, f_grid, obs_px=obs_px)


def _p3p_focal_sweep_multi(world, obs_px_per_f, f_grid):
    """`_p3p_focal_sweep` where the observations already carry the focal
    axis (per-focal undistorted pixels), obs_px_per_f (..., F, N, 2)."""
    xn = obs_px_per_f / f_grid[:, None, None]
    R, t, valid = _p3p_on_first_three(world, xn)
    return _score_sweep(R, t, valid, world, xn, f_grid)


def _take(x, idx, trailing: int):
    """x (..., M, *tail) at idx (..., K) along the candidate axis."""
    shape = idx.shape + x.shape[x.dim() - trailing:]
    return torch.gather(x, idx.dim() - 1, idx.reshape(idx.shape + (1,) * trailing).expand(shape))


def _log_grid(f_lo, f_hi, n, dtype, device):
    return torch.exp(torch.linspace(math.log(f_lo), math.log(f_hi), n, dtype=torch.float64)).to(dtype).to(device)


@f32_matmuls
def p4pf(world: torch.Tensor, obs_px: torch.Tensor, f_lo: float, f_hi: float, n_f: int = 24, top_k: int = 4):
    """Pose + unknown focal from 4 points (P4Pf): a log-spaced focal sweep
    feeds P3P on points 0-2, the 4th point ranks the (focal x root)
    candidates, and a joint Gauss-Newton over (so3, t, log f) polishes the
    best `top_k`. world: (..., 4, 3); obs_px: (..., 4, 2) pixels relative
    to the principal point. Returns (R (..., K, 3, 3), t (..., K, 3),
    f (..., K), valid (..., K)) with x_cam = R x_world + t."""
    f_grid = _log_grid(f_lo, f_hi, n_f, world.dtype, world.device)
    R, t, lf, score = _p3p_focal_sweep(world, obs_px, f_grid)
    idx = torch.topk(-score, top_k, dim=-1).indices
    R, t, lf = _take(R, idx, 2), _take(t, idx, 1), _take(lf, idx, 0)
    wK = world[..., None, :, :].expand(R.shape[:-2] + world.shape[-2:])
    oK = obs_px[..., None, :, :].expand(R.shape[:-2] + obs_px.shape[-2:])
    R, t, lf, _ = _pose_focal_refine(R, t, lf, wK, oK)
    f = torch.exp(lf)
    Xc = wK @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.clamp(Xc[..., 2:], min=1e-6)
    err = torch.linalg.norm(Xc[..., :2] / z * f[..., None, None] - oK, dim=-1)
    valid = (torch.amax(err, -1) < 1e-2 * f) & torch.all(Xc[..., 2] > 0, -1)
    valid &= torch.isfinite(R).flatten(-2).all(-1)
    return R, t, f, valid


@f32_matmuls
def p5pfr(world: torch.Tensor, obs_px: torch.Tensor, f_lo: float, f_hi: float, n_f: int = 16, n_k: int = 7,
          top_k: int = 4):
    """Pose + focal + radial distortion from 5 points (P5Pfr): a fixed
    (focal x division-model k1) grid undistorts the observations, P3P on
    points 0-2 is scored by points 3-4, and a joint Gauss-Newton over
    (so3, t, log f, k1) polishes the best `top_k`. world: (..., 5, 3);
    obs_px: (..., 5, 2) centred pixels. Returns (R (..., K, 3, 3),
    t (..., K, 3), f (..., K), k1 (..., K), valid (..., K)); k1 acts on
    focal-normalized radii: x_u = x_d / (1 + k1 |x_d / f|^2)."""
    dt, dev = world.dtype, world.device
    f_grid = _log_grid(f_lo, f_hi, n_f, dt, dev)
    k_grid = torch.linspace(-0.6, 0.3, n_k, dtype=torch.float64).to(dt).to(dev)
    Rs, ts, lfs, kks, scores = [], [], [], [], []
    for ki in range(n_k):
        k = k_grid[ki]
        # the observations undistorted at this k1 for every focal of the sweep
        xn = obs_px[..., None, :, :] / f_grid[:, None, None]
        und = xn / (1.0 + k * torch.sum(xn * xn, -1, keepdim=True))
        R, t, lf, score = _p3p_focal_sweep_multi(world, und * f_grid[:, None, None], f_grid)
        Rs.append(R)
        ts.append(t)
        lfs.append(lf)
        kks.append(torch.full_like(score, float(k)))
        scores.append(score)
    R, t, lf, kk, score = (torch.cat(Rs, dim=-3), torch.cat(ts, dim=-2), torch.cat(lfs, dim=-1),
                           torch.cat(kks, dim=-1), torch.cat(scores, dim=-1))
    idx = torch.topk(-score, top_k, dim=-1).indices
    R, t, lf, kk = _take(R, idx, 2), _take(t, idx, 1), _take(lf, idx, 0), _take(kk, idx, 0)
    wK = world[..., None, :, :].expand(R.shape[:-2] + world.shape[-2:])
    oK = obs_px[..., None, :, :].expand(R.shape[:-2] + obs_px.shape[-2:])
    R, t, lf, kk = _pose_focal_refine(R, t, lf, wK, oK, k1=kk)
    f = torch.exp(lf)
    Xc = wK @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.clamp(Xc[..., 2:], min=1e-6)
    xn = oK / f[..., None, None]
    und = xn / (1.0 + kk[..., None, None] * torch.sum(xn * xn, -1, keepdim=True))
    err = torch.linalg.norm((Xc[..., :2] / z - und) * f[..., None, None], dim=-1)
    valid = (torch.amax(err, -1) < 1e-2 * f) & torch.all(Xc[..., 2] > 0, -1)
    valid &= torch.isfinite(R).flatten(-2).all(-1)
    return R, t, f, kk, valid
