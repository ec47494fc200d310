"""Marker-based localization + trajectory refinement.

Port of `alicevision_tpu/localization/marker_localizer.py`, the
counterparts of the reference's CCTagLocalizer (localize a camera against
a scene whose landmarks are marker centres, ref:
src/aliceVision/localization/CCTagLocalizer.hpp:37-108: detection,
id association, resection) and of the sequence refinement (ref:
src/aliceVision/localization/optimization.cpp refineSequence: BA over the
localized frames with the 3D structure fixed, shared intrinsics refined
jointly).

Id association is an exact table lookup (markers match by id), the pose
comes from the batched robust P3P on the device, and refineSequence is a
joint Gauss-Newton over every frame pose and the shared focal at once:
the normal equations are block-diagonal in the 6-dof poses with one dense
column to the focal, which a Schur complement over the batched 6x6 blocks
eliminates. The per-frame Jacobians are closed-form (left-perturbed pose,
the focal column is the projection), where the reference takes
`jax.jacfwd` of each frame inside a `lax.scan`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..features.markers import MarkerDetection, detect_cctags
from ..geometry.rotations import so3_exp
from ..multiview.resection import _normalized_plane_jacobian
from ..numeric import f32_matmuls
from .localizer import LocalizationResult, resect_padded


def localize_by_markers(
    generator: torch.Generator | None,
    detections: list[MarkerDetection],
    marker_world: dict[int, np.ndarray],
    focal_px: float,
    im_size: tuple[float, float],
    min_markers: int = 4,
    n_hyps: int = 64,
    max_error_px: float = 4.0,
    idx=None,
    device="cuda",
) -> LocalizationResult:
    """Associate detected marker ids with known 3D marker positions and
    resect (CCTagLocalizer::localize). Needs >= min_markers visible.
    idx (n_hyps, 3): RANSAC samples to use instead of drawing them."""
    pts2d, pts3d = [], []
    W, H = im_size
    for d in detections:
        if d.marker_id in marker_world:
            pts2d.append(d.center)
            pts3d.append(np.asarray(marker_world[d.marker_id], np.float64))
    if len(pts2d) < max(min_markers, 4):
        return LocalizationResult(np.eye(3), np.zeros(3), 0, False)
    world = np.stack(pts3d)
    obs_norm = (np.stack(pts2d) - np.array([W / 2.0, H / 2.0])) / focal_px
    R, t, ni = resect_padded(generator, world, obs_norm, focal_px, im_size, n_hyps, max_error_px, idx=idx,
                             floor=8, device=device)
    if ni < min_markers:
        return LocalizationResult(np.eye(3), np.zeros(3), ni, False)
    return LocalizationResult(R, -R.T @ t, ni, True)


def localize_image_by_markers(
    generator: torch.Generator | None,
    img: np.ndarray,
    marker_world: dict[int, np.ndarray],
    focal_px: float,
    **kw,
) -> LocalizationResult:
    """Detect CCTag ring markers in `img` (on the host), then
    localize_by_markers."""
    dets = detect_cctags(np.asarray(img, np.float32))
    H, W = np.asarray(img).shape[:2]
    return localize_by_markers(generator, dets, marker_world, focal_px, (float(W), float(H)), **kw)


# ---------------------------------------------------------------------------
# Sequence refinement (optimization.cpp refineSequence analog)
# ---------------------------------------------------------------------------


class SequenceRefineResult(NamedTuple):
    R: torch.Tensor  # (F, 3, 3) world->cam
    t: torch.Tensor  # (F, 3)
    focal: torch.Tensor  # scalar shared focal (px)
    rms_px: torch.Tensor  # scalar final RMS reprojection error


@f32_matmuls
def refine_sequence(
    R0,  # (F, 3, 3)
    t0,  # (F, 3)
    world,  # (F, M, 3) fixed 3D points per frame (padded)
    uv,  # (F, M, 2) pixel observations
    mask,  # (F, M) valid observations
    focal0: float,
    principal: tuple[float, float],
    n_rounds: int = 4,
    pose_iters: int = 4,
    refine_focal: bool = True,
    device="cuda",
) -> SequenceRefineResult:
    """Joint Gauss-Newton over all frame poses + the shared focal, with the
    structure fixed; `n_rounds * pose_iters` joint Schur steps in all (the
    two knobs keep the reference's signature; each step is a full joint
    solve). Every per-frame quantity is one batch on `device`."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a),
                               dtype=torch.float32, device=dev)

    pp = f32(principal)
    world, uv = f32(world), f32(uv)
    R, t, f = f32(R0), f32(t0), f32(focal0)
    m = torch.as_tensor(np.asarray(mask.cpu() if torch.is_tensor(mask) else mask), device=dev)
    wflat = m.to(torch.float32).repeat_interleave(2, dim=-1)  # (F, 2M)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    for _ in range(n_rounds * max(1, pose_iters)):
        proj, _, J = _normalized_plane_jacobian(R, t, world)
        Jp = (f * J).flatten(-3, -2)  # (F, 2M, 6)
        Jf = proj.flatten(-2)  # (F, 2M)
        r = (f * proj + pp - uv).flatten(-2) * wflat
        Jp = Jp * wflat[..., None]
        Jf = Jf * wflat
        A = Jp.transpose(-1, -2) @ Jp + 1e-6 * eye6
        b = -(Jp.transpose(-1, -2) @ r[..., None])[..., 0]
        g = (Jp.transpose(-1, -2) @ Jf[..., None])[..., 0]
        h = torch.sum(Jf * Jf, dim=-1)
        c = -torch.sum(Jf * r, dim=-1)
        Ainv_b = torch.linalg.solve(A, b[..., None])[..., 0]
        Ainv_g = torch.linalg.solve(A, g[..., None])[..., 0]
        if refine_focal:
            S = torch.sum(h) - torch.sum(g * Ainv_g) + 1e-6
            df = (torch.sum(c) - torch.sum(g * Ainv_b)) / S
        else:
            df = torch.zeros((), dtype=torch.float32, device=dev)
        dx = Ainv_b - Ainv_g * df
        R = so3_exp(dx[:, :3]) @ R
        t = t + dx[:, 3:]
        f = f + df
    Xc = world @ R.transpose(-1, -2) + t[:, None, :]
    proj = Xc[..., :2] / torch.clamp(Xc[..., 2:], min=1e-6)
    err = (f * proj + pp - uv) * m.to(torch.float32)[..., None]
    rms = torch.sqrt(torch.sum(err**2) / torch.clamp(m.sum() * 2, min=1))
    return SequenceRefineResult(R, t, f, rms)
