"""High-level robust model estimators: F and H.

Port of the F and H half of `alicevision_tpu/robust/estimators.py` (ref:
src/aliceVision/matchingImageCollection/GeometricFilterMatrix_F_AC.hpp,
_H_AC.hpp). Each estimator draws a fixed batch of minimal samples, solves
all hypotheses in closed form, scores the full residual matrix, selects by
AC-RANSAC and refits on the inliers. The essential, relative-pose and
resection estimators need `multiview/five_point.py` and `resection.py`,
which the SfM-engine slice ports.

Every estimator takes either a `torch.Generator` (on the data's device) or
the sample indices `idx` drawn elsewhere — the parity tests pass the
reference's draws, since the two libraries' random streams differ.
`robust_fundamental_batch` is the same computation with a leading batch
axis written out (the reference vmaps `robust_fundamental`).
"""

from __future__ import annotations

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
    """x (..., N, 2) at sample indices idx (..., H, s) -> (..., H, s, 2)."""
    lead = idx.shape[:-2]
    flat = idx.to(torch.int64).reshape(lead + (-1,))
    out = torch.gather(x, -2, flat[..., None].expand(flat.shape + (2,)))
    return out.reshape(idx.shape + (2,))


def _take_model(models: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """models (..., H, 3, 3) at hypothesis best (...) -> (..., 3, 3)."""
    idx = best[..., None, None, None].expand(best.shape + (1, 3, 3))
    return torch.gather(models, -3, idx)[..., 0, :, :]


def _robust(solver, residual, sample_size, logalpha0, mult_error, generator, x1, x2, valid, n_hyps,
            max_error_px, idx):
    """The shared body: sample, solve, score, select, refit on the
    inliers. Returns (selection, hypotheses, refit model, refit residuals);
    the caller keeps the refit only if it does not lose inliers."""
    if idx is None:
        idx = sample_minimal(generator, x1.shape[-2], sample_size, n_hyps, valid, device=x1.device)
    models = solver(_gather_points(x1, idx), _gather_points(x2, idx))  # (..., H, 3, 3)
    res = residual(models, x1[..., None, :, :], x2[..., None, :, :])  # (..., H, N)
    sel = acransac_select(
        res,
        sample_size=sample_size,
        logalpha0=logalpha0,
        mult_error=mult_error,
        valid=valid,
        max_threshold_sq=max_error_px**2,
    )
    best = solver(x1, x2, mask=sel.inliers)
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
        generator, x1, x2, valid, n_hyps, max_error_px, idx,
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
        generator, x1, x2, valid, n_hyps, max_error_px, idx,
    )
    v = torch.ones_like(sel.inliers) if valid is None else valid
    inl = (res_ref <= sel.threshold_sq[..., None]) & v
    better = torch.sum(inl, dim=-1) >= sel.n_inliers
    H_out = torch.where(better[..., None, None], H_best, _take_model(H, sel.best_hyp))
    inl_out = torch.where(better[..., None], inl, sel.inliers)
    return RobustModel(H_out, inl_out, torch.sum(inl_out, dim=-1), sel.best_nfa, sel.threshold_sq)
