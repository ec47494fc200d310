"""Absolute-pose (resection) solvers on the SfM engine's path: P3P, Kabsch
and the Gauss-Newton pose refinement.

Port of part of `alicevision_tpu/multiview/resection.py` (ref:
src/aliceVision/multiview/resection/P3PSolver.hpp:19). P3P is Grunert's
formulation [Haralick et al., IJCV 1994]: the two depth-ratio quadratics'
resultant, a quartic in v, is sampled at five abscissae and interpolated
through a fixed Vandermonde inverse (computed once, here in float64), then
rooted with the closed-form Ferrari solver; up to 4 candidate poses a
sample, with a validity mask. The Gauss-Newton refinement takes the
closed-form Jacobian of the normalized-plane residuals where the reference
takes `jax.jvp` columns.

The rest of the reference module (`resection_dlt6`, `epnp`, `p4pf`,
`p5pfr`, the focal sweeps) has no caller on the main path and waits for a
later slice (ROADMAP queue 13).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.rotations import hat, so3_exp
from ..numeric import f32_matmuls, quartic_roots_real, svd

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
    eye3 = torch.eye(3, dtype=world.dtype, device=world.device)
    eye6 = torch.eye(6, dtype=world.dtype, device=world.device)
    for _ in range(iters):
        RX = world @ R.transpose(-1, -2)  # (..., N, 3)
        Xc = RX + t[..., None, :]
        zr = Xc[..., 2]
        z = torch.clamp(zr, min=1e-6)
        uv = Xc[..., :2] / z[..., None]
        r = (uv - obs_norm) * w[..., None]  # (..., N, 2)
        dz = (zr > 1e-6).to(world.dtype) / z  # 0 where the depth is clamped
        zero = torch.zeros_like(z)
        inv_z = 1.0 / z
        dproj = torch.stack(
            [torch.stack([inv_z, zero, -uv[..., 0] * dz], -1), torch.stack([zero, inv_z, -uv[..., 1] * dz], -1)],
            dim=-2,
        ) * w[..., None, None]  # (..., N, 2, 3)
        dX = torch.cat([-hat(RX), eye3.expand(RX.shape + (3,))], dim=-1)  # (..., N, 3, 6)
        J = dproj @ dX
        J = J.reshape(J.shape[:-3] + (-1, 6))  # (..., 2N, 6)
        JtJ = J.transpose(-1, -2) @ J + 1e-8 * eye6
        Jtr = J.transpose(-1, -2) @ r.reshape(r.shape[:-2] + (-1, 1))
        dx = -torch.linalg.solve_ex(JtJ, Jtr)[0][..., 0]
        R = so3_exp(dx[..., :3]) @ R
        t = t + dx[..., 3:]
    return R, t
