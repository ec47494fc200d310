"""High-level robust model estimators: F / E / H / absolute pose.

Port of `alicevision_tpu/robust/estimators.py` (ref:
src/aliceVision/matchingImageCollection/GeometricFilterMatrix_F_AC.hpp,
_E_AC.hpp, _H_AC.hpp; the SfM resection at
src/aliceVision/sfm/pipeline/sequential/ReconstructionEngine_sequentialSfM.hpp:71).
Each estimator draws a fixed batch of minimal samples, solves all
hypotheses in closed form, scores the full residual matrix, selects by
AC-RANSAC and refits on the inliers.

Every estimator takes either a `torch.Generator` (on the data's device) or
the sample indices `idx` drawn elsewhere — the parity tests pass the
reference's draws, since the two libraries' random streams differ. Inputs
may carry leading batch dimensions: the `*_batch` forms are the same
computation over a (B, ...) bucket (the reference vmaps the single forms),
so a chunk of pairs or a resection group is one call that reads nothing
back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import multiview as mv
from ..numeric import f32_matmuls
from .ransac import acransac_select, logalpha0_line, logalpha0_point, sample_minimal


class RobustModel(NamedTuple):
    model: torch.Tensor  # (..., 3, 3) F or H
    inliers: torch.Tensor  # (..., N) bool
    n_inliers: torch.Tensor  # (...) int64
    nfa: torch.Tensor  # (...) float32
    threshold_sq: torch.Tensor  # (...) adaptive threshold


def _gather_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, d) at sample indices idx (..., H, s) -> (..., H, s, d)."""
    lead = idx.shape[:-2]
    d = x.shape[-1]
    flat = idx.to(torch.int64).reshape(lead + (-1,))
    out = torch.gather(x, -2, flat[..., None].expand(flat.shape + (d,)))
    return out.reshape(idx.shape + (d,))


def _take_model(models: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """models (..., H, 3, 3) at hypothesis best (...) -> (..., 3, 3)."""
    idx = best[..., None, None, None].expand(best.shape + (1, 3, 3))
    return torch.gather(models, -3, idx)[..., 0, :, :]


def _robust(solver, residual, sample_size, logalpha0, mult_error, generator, x1, x2, valid, n_hyps,
            max_threshold_sq, idx, refit=None):
    """The shared body: sample, solve, score, select, refit on the
    inliers (with `refit`, else the minimal solver). A solver that returns
    (candidates (..., H, c, 3, 3), valid (..., H, c)) — the 5-point one —
    gives H*c hypotheses, the invalid ones scored +inf. Returns (selection,
    hypotheses, refit model, refit residuals); the caller keeps the refit
    only if it does not lose inliers."""
    if idx is None:
        idx = sample_minimal(generator, x1.shape[-2], sample_size, n_hyps, valid, device=x1.device)
    models = solver(_gather_points(x1, idx), _gather_points(x2, idx))  # (..., H, 3, 3)
    ok = None
    if isinstance(models, tuple):
        models, ok = models[0].flatten(-4, -3), models[1].flatten(-2)
    res = residual(models, x1[..., None, :, :], x2[..., None, :, :])  # (..., H, N)
    if ok is not None:
        res = torch.where(ok[..., None], res, torch.full_like(res, math.inf))
    sel = acransac_select(
        res,
        sample_size=sample_size,
        logalpha0=logalpha0,
        mult_error=mult_error,
        valid=valid,
        max_threshold_sq=max_threshold_sq,
    )
    best = (refit or solver)(x1, x2, mask=sel.inliers)
    res_ref = residual(best, x1, x2)
    return sel, models, best, res_ref


@f32_matmuls
def robust_fundamental(
    generator: torch.Generator | None,
    x1: torch.Tensor,
    x2: torch.Tensor,
    im_size: tuple[float, float],
    valid: torch.Tensor | None = None,
    n_hyps: int = 256,
    max_error_px: float = 4.0,
    idx: torch.Tensor | None = None,
) -> RobustModel:
    """AC-RANSAC fundamental matrix from pixel correspondences (..., N, 2).
    idx (..., n_hyps, 8): sample indices to use instead of drawing them."""
    sel, F, F_best, res_ref = _robust(
        mv.fundamental_8pt, mv.epipolar_distance_sq, 8, logalpha0_line(*im_size), 0.5,
        generator, x1, x2, valid, n_hyps, max_error_px**2, idx,
    )
    v = torch.ones_like(sel.inliers) if valid is None else valid
    inl = (res_ref <= sel.threshold_sq[..., None]) & (sel.inliers | v)
    better = torch.sum(inl, dim=-1) >= sel.n_inliers
    F_out = torch.where(better[..., None, None], F_best, _take_model(F, sel.best_hyp))
    inl_out = torch.where(better[..., None], inl, sel.inliers)
    return RobustModel(F_out, inl_out, torch.sum(inl_out, dim=-1), sel.best_nfa, sel.threshold_sq)


def robust_fundamental_batch(
    generator: torch.Generator | None,
    x1: torch.Tensor,
    x2: torch.Tensor,
    im_size: tuple[float, float],
    valid: torch.Tensor,
    n_hyps: int = 256,
    max_error_px: float = 4.0,
    idx: torch.Tensor | None = None,
) -> RobustModel:
    """AC-RANSAC F for a (B, N, 2) bucket of pairs in one batched call.
    idx (B, n_hyps, 8): sample indices to use instead of drawing them."""
    return robust_fundamental(generator, x1, x2, im_size, valid, n_hyps, max_error_px, idx)


@f32_matmuls
def robust_homography(
    generator: torch.Generator | None,
    x1: torch.Tensor,
    x2: torch.Tensor,
    im_size: tuple[float, float],
    valid: torch.Tensor | None = None,
    n_hyps: int = 256,
    max_error_px: float = 4.0,
    idx: torch.Tensor | None = None,
) -> RobustModel:
    """AC-RANSAC homography from pixel correspondences (..., N, 2).
    idx (..., n_hyps, 4): sample indices to use instead of drawing them."""
    sel, H, H_best, res_ref = _robust(
        mv.homography_4pt, mv.homography_error_sq, 4, logalpha0_point(*im_size), 1.0,
        generator, x1, x2, valid, n_hyps, max_error_px**2, idx,
    )
    v = torch.ones_like(sel.inliers) if valid is None else valid
    inl = (res_ref <= sel.threshold_sq[..., None]) & v
    better = torch.sum(inl, dim=-1) >= sel.n_inliers
    H_out = torch.where(better[..., None, None], H_best, _take_model(H, sel.best_hyp))
    inl_out = torch.where(better[..., None], inl, sel.inliers)
    return RobustModel(H_out, inl_out, torch.sum(inl_out, dim=-1), sel.best_nfa, sel.threshold_sq)


@f32_matmuls
def robust_essential(
    generator: torch.Generator | None,
    x1n: torch.Tensor,
    x2n: torch.Tensor,
    focal_mean: float,
    im_size: tuple[float, float],
    valid: torch.Tensor | None = None,
    n_hyps: int = 256,
    max_error_px: float = 4.0,
    solver: str = "5pt",
    idx: torch.Tensor | None = None,
) -> RobustModel:
    """AC-RANSAC essential matrix from normalized-camera correspondences
    (..., N, 2). solver="5pt" (the reference's default kernel,
    Essential5PSolver.hpp:17): every polished 5-point candidate is a
    hypothesis, invalid slots scored +inf; "8pt": the linear solver. The
    residual is the epipolar distance in the normalized plane; alpha0 uses
    the image domain divided by the mean focal. idx (..., n_hyps, 5 or 8):
    sample indices to use instead of drawing them."""
    if solver == "5pt":
        sample_size, minimal = 5, mv.essential_5pt
    else:
        sample_size, minimal = 8, mv.essential_8pt
    w, h = im_size
    sel, E, E_best, res_ref = _robust(
        minimal, mv.epipolar_distance_sq, sample_size, logalpha0_line(w / focal_mean, h / focal_mean), 0.5,
        generator, x1n, x2n, valid, n_hyps, (max_error_px / focal_mean) ** 2, idx, refit=mv.essential_8pt,
    )
    v = torch.ones_like(sel.inliers) if valid is None else valid
    inl = (res_ref <= sel.threshold_sq[..., None]) & v
    better = torch.sum(inl, dim=-1) >= sel.n_inliers
    E_out = torch.where(better[..., None, None], E_best, _take_model(E, sel.best_hyp))
    inl_out = torch.where(better[..., None], inl, sel.inliers)
    return RobustModel(E_out, inl_out, torch.sum(inl_out, dim=-1), sel.best_nfa, sel.threshold_sq)


@f32_matmuls
def robust_relative_pose(
    generator: torch.Generator | None,
    x1n: torch.Tensor,
    x2n: torch.Tensor,
    focal_mean: float,
    im_size: tuple[float, float],
    valid: torch.Tensor | None = None,
    n_hyps: int = 256,
    max_error_px: float = 4.0,
    solver: str = "5pt",
    idx: torch.Tensor | None = None,
):
    """Essential + cheirality -> relative pose (R, t, RobustModel), the SfM
    initial-pair step (ref: makeInitialPair3D)."""
    rm = robust_essential(generator, x1n, x2n, focal_mean, im_size, valid, n_hyps, max_error_px, solver, idx)
    R4, t4 = mv.decompose_essential(rm.model)
    R, t, _ = mv.select_cheirality(R4, t4, x1n, x2n, mask=rm.inliers)
    return R, t, rm


class RelativePoseBatch(NamedTuple):
    R: torch.Tensor  # (B, 3, 3)
    t: torch.Tensor  # (B, 3)
    inliers: torch.Tensor  # (B, N)
    n_inliers: torch.Tensor  # (B,)


def robust_relative_pose_batch(
    generator, x1n, x2n, focal_mean, im_size, valid, n_hyps: int = 256, max_error_px: float = 4.0,
    solver: str = "5pt", idx: torch.Tensor | None = None,
) -> RelativePoseBatch:
    """Relative pose for a (B, N, 2) bucket of pairs in one batched call."""
    R, t, rm = robust_relative_pose(generator, x1n, x2n, focal_mean, im_size, valid, n_hyps, max_error_px,
                                    solver, idx)
    return RelativePoseBatch(R, t, rm.inliers, rm.n_inliers)


class RobustPose(NamedTuple):
    R: torch.Tensor  # (..., 3, 3) world->camera
    t: torch.Tensor  # (..., 3)
    inliers: torch.Tensor  # (..., N) bool
    n_inliers: torch.Tensor
    nfa: torch.Tensor
    threshold_sq: torch.Tensor  # in normalized-plane units


def _pose_residuals(R, t, world, obs_norm):
    """Squared normalized-plane residuals of world (..., N, 3) under poses
    R (..., M, 3, 3), t (..., M, 3), and the depths: (..., M, N) each."""
    Xc = world[..., None, :, :] @ R.transpose(-1, -2) + t[..., None, :]
    z = Xc[..., 2]
    uv = Xc[..., :2] / torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)[..., None]
    return torch.sum((uv - obs_norm[..., None, :, :]) ** 2, dim=-1), z


@f32_matmuls
def robust_resection_p3p(
    generator: torch.Generator | None,
    world: torch.Tensor,
    obs_norm: torch.Tensor,
    focal_mean: float,
    im_size: tuple[float, float],
    valid: torch.Tensor | None = None,
    n_hyps: int = 128,
    max_error_px: float = 4.0,
    refine_iters: int = 8,
    idx: torch.Tensor | None = None,
) -> RobustPose:
    """AC-RANSAC absolute pose: P3P hypotheses (4 a sample, invalid ones
    scored +inf) + Gauss-Newton refit on the inliers. world: (..., N, 3),
    obs_norm: (..., N, 2) undistorted normalized-plane observations
    (ref: P3PSolver.hpp:19 + SfMLocalizer refine). idx (..., n_hyps, 3):
    sample indices to use instead of drawing them."""
    if idx is None:
        idx = sample_minimal(generator, world.shape[-2], 3, n_hyps, valid, device=world.device)
    rays = torch.cat([obs_norm, torch.ones_like(obs_norm[..., :1])], dim=-1)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    R4, t4, ok4 = mv.p3p(_gather_points(world, idx), _gather_points(rays, idx))  # (..., H, 4, ...)
    Rf, tf, okf = R4.flatten(-4, -3), t4.flatten(-3, -2), ok4.flatten(-2)

    res, z = _pose_residuals(Rf, tf, world, obs_norm)  # (..., 4H, N)
    res = torch.where((z > 0) & okf[..., None], res, torch.full_like(res, math.inf))
    w, h = im_size
    sel = acransac_select(
        res,
        sample_size=3,
        logalpha0=logalpha0_point(w / focal_mean, h / focal_mean),
        mult_error=1.0,
        valid=valid,
        max_threshold_sq=(max_error_px / focal_mean) ** 2,
    )
    R0 = _take_model(Rf, sel.best_hyp)
    t0 = torch.gather(tf, -2, sel.best_hyp[..., None, None].expand(sel.best_hyp.shape + (1, 3)))[..., 0, :]
    Rr, tr = mv.gauss_newton_pose_refine(R0, t0, world, obs_norm, mask=sel.inliers, iters=refine_iters)
    # inliers under the refined pose
    res_r, z_r = _pose_residuals(Rr[..., None, :, :], tr[..., None, :], world, obs_norm)
    v = torch.ones_like(sel.inliers) if valid is None else valid
    inl = (res_r[..., 0, :] <= sel.threshold_sq[..., None]) & (z_r[..., 0, :] > 0) & v
    better = torch.sum(inl, dim=-1) >= sel.n_inliers
    R_out = torch.where(better[..., None, None], Rr, R0)
    t_out = torch.where(better[..., None], tr, t0)
    inl_out = torch.where(better[..., None], inl, sel.inliers)
    return RobustPose(R_out, t_out, inl_out, torch.sum(inl_out, dim=-1), sel.best_nfa, sel.threshold_sq)


def robust_resection_p3p_batch(
    generator, world, obs_norm, focal_mean, im_size, valid, n_hyps: int = 128, max_error_px: float = 4.0,
    refine_iters: int = 8, idx: torch.Tensor | None = None,
) -> RobustPose:
    """Robust resection of a (B, N, 3) / (B, N, 2) group in one batched
    call, shared focal (a resection group of the SfM engine)."""
    return robust_resection_p3p(generator, world, obs_norm, focal_mean, im_size, valid, n_hyps, max_error_px,
                                refine_iters, idx)
