"""Zhang planar camera calibration.

Port of `alicevision_tpu/calibration/zhang.py` (ref:
src/aliceVision/calibration/calibration.cpp — cv::calibrateCamera
wrapper): per-view plane homographies (DLT), closed-form intrinsics from
the absolute-conic constraints [Zhang00], per-view pose recovery, then a
joint Gauss-Newton refinement of (fx, fy, cx, cy, k1, k2, poses) on the
reprojection error, on the inputs' device in float32. The small
decompositions are taken in float64 (`numeric.eigh64`, `svd64`,
`solve64`): the B-matrix rows run from 1/f² to 1, and a card's float32
eigh loses such a system's smallest eigenvector.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.rotations import so3_exp, so3_log
from ..numeric import eigh64, f32_matmuls, solve64, svd64


def homography_dlt_planar(obj_xy: torch.Tensor, img_xy: torch.Tensor) -> torch.Tensor:
    """Homography board-plane -> image, ((..., N, 2), (..., N, 2)) -> (..., 3, 3)."""
    from ..multiview.epipolar import homography_4pt

    return homography_4pt(obj_xy, img_xy)


def _v_ij(H, i, j):
    return torch.stack([
        H[..., 0, i] * H[..., 0, j],
        H[..., 0, i] * H[..., 1, j] + H[..., 1, i] * H[..., 0, j],
        H[..., 1, i] * H[..., 1, j],
        H[..., 2, i] * H[..., 0, j] + H[..., 0, i] * H[..., 2, j],
        H[..., 2, i] * H[..., 1, j] + H[..., 1, i] * H[..., 2, j],
        H[..., 2, i] * H[..., 2, j],
    ], dim=-1)


@f32_matmuls
def intrinsics_from_homographies(Hs: torch.Tensor) -> torch.Tensor:
    """Closed-form K from >= 3 homographies (Zhang's B-matrix route):
    the smallest eigenvector of AᵀA in float64. Hs: (V, 3, 3) -> K (3, 3)."""
    A = torch.stack([_v_ij(Hs, 0, 1), _v_ij(Hs, 0, 0) - _v_ij(Hs, 1, 1)], dim=1).reshape(-1, 6)
    _, V = eigh64(A.T @ A)
    B11, B12, B22, B13, B23, B33 = V[:, 0]
    v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 * B12)
    lam = B33 - (B13 * B13 + v0 * (B12 * B13 - B11 * B23)) / B11
    alpha = torch.sqrt(torch.abs(lam / B11))
    beta = torch.sqrt(torch.abs(lam * B11 / (B11 * B22 - B12 * B12)))
    gamma = -B12 * alpha * alpha * beta / lam
    u0 = gamma * v0 / beta - B13 * alpha * alpha / lam
    zero, one = torch.zeros_like(alpha), torch.ones_like(alpha)
    return torch.stack([alpha, gamma, u0, zero, beta, v0, zero, zero, one]).reshape(3, 3)


@f32_matmuls
def pose_from_homography(K: torch.Tensor, H: torch.Tensor):
    """Per-view (R, t) from H = K [r1 r2 t] (board plane z = 0), H
    (..., 3, 3); R projected onto SO(3) by a float64 SVD."""
    Kinv = torch.linalg.inv(K)
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    k1 = torch.einsum("ij,...j->...i", Kinv, h1)
    lam = 1.0 / torch.linalg.norm(k1, dim=-1, keepdim=True).clamp(min=1e-12)
    r1 = lam * k1
    r2 = lam * torch.einsum("ij,...j->...i", Kinv, h2)
    r3 = torch.cross(r1, r2, dim=-1)
    R = torch.stack([r1, r2, r3], dim=-1)
    U, _, Vt = svd64(R)
    R = U @ Vt
    R = R * torch.sign(torch.linalg.det(R))[..., None, None]
    t = lam * torch.einsum("ij,...j->...i", Kinv, h3)
    return R, t


@f32_matmuls
def calibrate_zhang(obj_xy, img_pts, refine_iters: int = 20, device="cuda"):
    """Full calibration of the board corners obj_xy (N, 2) (the same for
    every view) seen at img_pts (V, N, 2), on `device`. Returns a dict with
    K, dist (k1, k2), R, t (host arrays) and rms."""
    dev = resolve_device(device)
    V, N, _ = np.shape(img_pts)
    obj = torch.as_tensor(np.asarray(obj_xy), dtype=torch.float32, device=dev)
    imgs = torch.as_tensor(np.asarray(img_pts), dtype=torch.float32, device=dev)

    Hs = homography_dlt_planar(obj.expand(V, N, 2), imgs)
    K0 = intrinsics_from_homographies(Hs)
    R0, t0 = pose_from_homography(K0, Hs)
    obj3 = torch.cat([obj, torch.zeros_like(obj[:, :1])], dim=-1)  # (N, 3)

    def unpack(x):
        return x[0], x[1], x[2], x[3], x[4], x[5], x[6:6 + 3 * V].reshape(V, 3), x[6 + 3 * V:].reshape(V, 3)

    def residuals(x):
        fx, fy, cx, cy, k1, k2, w, t = unpack(x)
        Xc = torch.einsum("vij,nj->vni", so3_exp(w), obj3) + t[:, None, :]
        z = Xc[..., 2].clamp(min=1e-6)
        p = Xc[..., :2] / z[..., None]
        r2 = (p * p).sum(-1)
        s = 1.0 + k1 * r2 + k2 * r2 * r2
        uv = torch.stack([fx * p[..., 0] * s + cx, fy * p[..., 1] * s + cy], -1)
        return (uv - imgs).reshape(-1)

    x = torch.cat([torch.stack([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]]),
                   torch.zeros(2, dtype=torch.float32, device=dev), so3_log(R0).reshape(-1), t0.reshape(-1)])
    eye = torch.eye(x.shape[0], dtype=torch.float32, device=dev)
    for _ in range(refine_iters):
        r = residuals(x)
        J = torch.func.jacfwd(residuals)(x)
        x_new = x - solve64(J.T @ J + 1e-6 * eye, (J.T @ r)[:, None])[:, 0]
        better = (residuals(x_new) ** 2).sum() < (r * r).sum()
        x = torch.where(better, x_new, x)
    fx, fy, cx, cy, k1, k2, w, t = unpack(x)
    r = residuals(x)
    K = torch.stack([fx, torch.zeros_like(fx), cx, torch.zeros_like(fx), fy, cy, torch.zeros_like(fx),
                     torch.zeros_like(fx), torch.ones_like(fx)]).reshape(3, 3)
    return {
        "K": K.cpu().numpy(),
        "dist": np.array([float(k1), float(k2)]),
        "R": so3_exp(w).cpu().numpy(),
        "t": t.cpu().numpy(),
        "rms": float(torch.sqrt((r * r).mean())),
    }
