"""Camera localization against a reconstructed scene.

Port of `alicevision_tpu/localization/localizer.py`, the counterpart of the
reference's localization module (ref:
src/aliceVision/localization/VoctreeLocalizer.hpp:34-153: retrieval +
feature matching + resection; sfm/pipeline/localization/SfMLocalizer.hpp:
P3P AC-RANSAC + pose refine). The landmark "descriptor index" is the mean
descriptor of each track's observations; query matching is one matrix
product on the device (`match_bruteforce`); the pose comes from the
batched robust P3P + Gauss-Newton refit.

RANSAC draws its samples from a `torch.Generator`; `idx` passes given
sample indices instead (the reference's draws, in the parity tests).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import robust
from ..device import resolve_device
from ..matching.descriptor_matching import match_bruteforce


class LocalizationResult(NamedTuple):
    R: np.ndarray  # (3, 3) world->cam
    c: np.ndarray  # (3,) camera center
    n_inliers: int
    success: bool


def build_landmark_index(
    points: np.ndarray,  # (L, 3)
    obs_landmark: np.ndarray,  # (O,)
    obs_desc: np.ndarray,  # (O, D) descriptor of each observation
) -> tuple[np.ndarray, np.ndarray]:
    """Mean descriptor per landmark -> (desc (L, D), points (L, 3))."""
    L = len(points)
    D = obs_desc.shape[1]
    acc = np.zeros((L, D), np.float64)
    cnt = np.zeros(L)
    np.add.at(acc, obs_landmark, obs_desc)
    np.add.at(cnt, obs_landmark, 1.0)
    desc = acc / np.maximum(cnt, 1)[:, None]
    norm = np.linalg.norm(desc, axis=-1, keepdims=True)
    return (desc / np.maximum(norm, 1e-12)).astype(np.float32), points


def _f32(a, dev):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)


def match_ratio(query_desc, cand_desc, ratio: float, device) -> np.ndarray:
    """Top-2 ratio matches of each query descriptor among the candidates on
    `device` (no cross check): the candidate index a row, -1 where none."""
    dev = resolve_device(device)
    q, c = _f32(query_desc, dev), _f32(cand_desc, dev)
    m = match_bruteforce(q, c, torch.ones(len(q), dtype=torch.bool, device=dev),
                         torch.ones(len(c), dtype=torch.bool, device=dev), ratio=ratio, cross_check=False)
    return m.idx2.cpu().numpy()


def match_2d3d(
    landmark_desc: np.ndarray,  # (L, D)
    landmark_pts: np.ndarray,  # (L, 3)
    query_desc: np.ndarray,  # (N, D)
    query_norm: np.ndarray,  # (N, 2) undistorted normalized coords
    ratio: float = 0.85,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Descriptor-matched (world (M, 3), obs (M, 2)) correspondences, the
    matching half of SfMLocalizer::Localize, exposed so the rig path can
    resect all cameras jointly (rigResection.cpp)."""
    if len(query_desc) == 0:
        return np.zeros((0, 3)), np.zeros((0, 2))
    idx2 = match_ratio(query_desc, landmark_desc, ratio, device)
    sel = np.nonzero(idx2 >= 0)[0]
    return landmark_pts[idx2[sel]], np.asarray(query_norm)[sel]


def _capacity(n: int, floor: int = 32) -> int:
    """The power-of-two slot count of the reference's padded RANSAC
    problems (its sample draws index these slots)."""
    return 1 << int(np.ceil(np.log2(max(n, floor))))


def resect_padded(generator, world, obs, focal_px, im_size, n_hyps, max_error_px=4.0, idx=None,
                  floor: int = 32, device="cuda"):
    """robust_resection_p3p on correspondences padded to the reference's
    power-of-two capacity: (R (3, 3), t (3,), n_inliers) on the host.

    n_inliers is 0 where no hypothesis is meaningful (AC-RANSAC's NFA
    +inf: none has a fourth residual under the max_error_px cap). There
    the reference's threshold keeps acransac_select's padding value
    (1e18), so its recount after the refine takes every point in front of
    the camera for an inlier, and a localizer accepts any pose of at least
    min_inliers correspondences: a reference fault that this function
    repairs (the estimator itself stays the reference's)."""
    dev = resolve_device(device)
    n = len(world)
    cap = _capacity(n, floor)
    valid = np.zeros(cap, bool)
    valid[:n] = True
    rp = robust.robust_resection_p3p(
        generator,
        _f32(np.pad(world, ((0, cap - n), (0, 0))), dev),
        _f32(np.pad(obs, ((0, cap - n), (0, 0))), dev),
        focal_px,
        im_size,
        valid=torch.from_numpy(valid).to(dev),
        n_hyps=n_hyps,
        max_error_px=max_error_px,
        idx=None if idx is None else torch.as_tensor(np.array(idx, np.int64), device=dev),
    )
    n_inliers = int(rp.n_inliers) if bool(torch.isfinite(rp.nfa)) else 0
    return rp.R.cpu().numpy(), rp.t.cpu().numpy(), n_inliers


def localize_image(
    generator: torch.Generator | None,
    landmark_desc: np.ndarray,  # (L, D)
    landmark_pts: np.ndarray,  # (L, 3)
    query_desc: np.ndarray,  # (N, D)
    query_norm: np.ndarray,  # (N, 2) undistorted normalized coords
    focal_px: float,
    im_size: tuple[float, float],
    ratio: float = 0.85,
    min_inliers: int = 12,
    n_hyps: int = 256,
    idx=None,
    device="cuda",
) -> LocalizationResult:
    """2D-3D matching + robust P3P resection (SfMLocalizer::Localize).
    idx (n_hyps, 3): RANSAC sample indices to use instead of drawing them."""
    world, obs = match_2d3d(landmark_desc, landmark_pts, query_desc, query_norm, ratio, device=device)
    if len(world) < min_inliers:
        return LocalizationResult(np.eye(3), np.zeros(3), 0, False)
    R, t, ni = resect_padded(generator, world, obs, focal_px, im_size, n_hyps, idx=idx, device=device)
    if ni < min_inliers:
        return LocalizationResult(np.eye(3), np.zeros(3), ni, False)
    return LocalizationResult(R, -R.T @ t, ni, True)
