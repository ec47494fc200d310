"""Distortion calibration from line straightness.

Port of `alicevision_tpu/calibration/distortion_lines.py` (ref:
src/aliceVision/calibration/distortionEstimationLine.cpp — straight scene
lines must undistort to straight image lines). Given tracked line points
(checkerboard rows and columns, or user-marked lines), Gauss-Newton
minimizes the point-to-fitted-line residual of the *undistorted* points
over the lens coefficients, on the points' device in float32 with the
Jacobian from `torch.func.jacfwd`; the small normal equations are solved in
float64 (`numeric.solve64`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import camera as cam
from ..device import resolve_device
from ..numeric import solve64


def _line_residuals(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Orthogonal distances of (G, N, 2) point groups to their best-fit
    lines, masked. The normal of each group's line is the minor axis of its
    2x2 covariance, in the half-angle form (cancellation-free in float32)."""
    w = mask.to(pts.dtype)[..., None]
    cnt = w.sum(1).clamp(min=1.0)
    mean = (pts * w).sum(1, keepdim=True) / cnt[:, None]
    d = (pts - mean) * w
    cov = torch.einsum("gni,gnj->gij", d, d)
    a, b, c = cov[:, 0, 0], cov[:, 0, 1], cov[:, 1, 1]
    theta = 0.5 * torch.atan2(2.0 * b, a - c)  # major-axis direction
    n = torch.stack([-torch.sin(theta), torch.cos(theta)], -1)  # minor axis
    return torch.einsum("gni,gi->gn", pts - mean, n) * mask.to(pts.dtype)


def _tensors(line_pts, mask, device):
    if isinstance(line_pts, torch.Tensor):
        return line_pts.float(), torch.as_tensor(mask, device=line_pts.device)
    dev = resolve_device(device)
    return (torch.as_tensor(np.asarray(line_pts), dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(mask), device=dev))


def calibrate_distortion_from_lines(line_pts, mask, intr: cam.Intrinsics, n_params: int = 3, iters: int = 25,
                                    device="cuda"):
    """Fit radial k1..k3 (RADIALK3 model) so undistorted lines are
    straight. line_pts (G, N, 2) distorted pixels per line, mask (G, N), a
    tensor (on its device) or host arrays (on `device`); intr an unbatched
    intrinsic row (focal and principal point fixed), moved to that device.
    Returns (disto (DISTO_PARAMS,) on the device, rms_before, rms_after)."""
    line_pts, mask = _tensors(line_pts, mask, device)
    dev = line_pts.device
    intr = cam.Intrinsics(*(x.to(dev) for x in intr))
    kind = torch.tensor(cam.DISTO_RADIALK3, dtype=torch.int32, device=dev)

    def residuals(params):
        disto = torch.cat([params, torch.zeros(cam.DISTO_PARAMS - n_params, dtype=params.dtype, device=dev)])
        row = intr._replace(disto_kind=kind, disto=disto)
        u = cam.remove_distortion(kind, disto, cam.ima2cam(row, line_pts))
        return _line_residuals(cam.cam2ima(row, u), mask).reshape(-1)

    params = torch.zeros(n_params, dtype=torch.float32, device=dev)
    r0 = residuals(params)
    eye = torch.eye(n_params, dtype=torch.float32, device=dev)
    for _ in range(iters):
        r = residuals(params)
        J = torch.func.jacfwd(residuals)(params)
        new = params - solve64(J.T @ J + 1e-8 * eye, (J.T @ r)[:, None])[:, 0]
        params = torch.where((residuals(new) ** 2).sum() < (r * r).sum(), new, params)
    r1 = residuals(params)
    disto = torch.cat([params, torch.zeros(cam.DISTO_PARAMS - n_params, dtype=params.dtype, device=dev)])
    return disto, float(torch.sqrt((r0 * r0).mean())), float(torch.sqrt((r1 * r1).mean()))


def calibrate_undistortion_from_lines(line_pts, mask, undist, free_idx=None, iters: int = 40, device="cuda"):
    """Fit an Undistortion-family model (3DE lens grids) so that undistorted
    lines are straight (ref: distortionEstimationLine.cpp +
    software/pipeline/main_distortionCalibration.cpp
    --undistortionModelName): Levenberg-Marquardt over the parameters
    `free_idx` (default: all of the model's) with the same point-to-line
    residual. Returns (fitted Undistortion, rms_before, rms_after) in pixels."""
    from ..camera import undistortion as und

    line_pts, mask = _tensors(line_pts, mask, device)
    dev = line_pts.device
    kind = int(undist.kind)
    if free_idx is None:
        free_idx = list(range(und.N_UNDIST_PARAMS[kind]))
    free_idx = torch.as_tensor(free_idx, dtype=torch.long, device=dev)
    base = torch.as_tensor(undist.params, dtype=torch.float32, device=dev)
    diag = undist.half_diagonal()
    pa = 1.0 if undist.is_desqueezed else undist.pixel_aspect_ratio
    center = torch.as_tensor(0.5 * np.asarray(undist.size) + np.asarray(undist.offset), dtype=torch.float32,
                             device=dev)
    norm = torch.tensor([diag, pa * diag], dtype=torch.float32, device=dev)
    pts_n = (line_pts - center) / norm

    def with_free(theta):
        return base.index_put((free_idx,), theta)

    def residuals(theta):
        u = und.undistort_normalized(kind, with_free(theta), undist.pixel_aspect_ratio, pts_n)
        return _line_residuals(u * norm + center, mask).reshape(-1)

    theta = base[free_idx]
    r0 = residuals(theta)
    n = theta.shape[0]
    eye = torch.eye(n, dtype=torch.float32, device=dev)
    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    for _ in range(iters):
        r = residuals(theta)
        J = torch.func.jacfwd(residuals)(theta)
        new = theta - solve64(J.T @ J + lam * eye, (J.T @ r)[:, None])[:, 0]
        better = (residuals(new) ** 2).sum() < (r * r).sum()
        theta = torch.where(better, new, theta)
        lam = torch.where(better, lam * 0.5, lam * 4.0).clamp(1e-10, 1e6)
    r1 = residuals(theta)
    fitted = undist._replace(params=with_free(theta).cpu().numpy().astype(np.float64))
    return fitted, float(torch.sqrt((r0 * r0).mean())), float(torch.sqrt((r1 * r1).mean()))
