"""Batched fixed-budget RANSAC with a-contrario (ACRANSAC) model selection.

Port of `alicevision_tpu/robust/ransac.py` (ref:
src/aliceVision/robustEstimation/ACRansac.hpp:78-146, Ransac.hpp). A fixed
batch of H minimal samples is drawn, all hypotheses are solved at once by
the batched closed-form solvers, the full H x N residual matrix is scored,
and the hypothesis with the lowest NFA wins; the a-contrario criterion also
gives the adaptive inlier threshold.

NFA(model, k) = log10(n_models * (n - s)) + logC(n, k) + logC(k, s)
               + (k - s) * (logalpha0 + mult * log10(e_k^2))
with e_k the k-th smallest residual and s the minimal sample size.

The selections take leading batch dimensions — res_sq (..., H, N) — so a
chunk of image pairs is one call, and none of them reads a value back to
the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_EPS = 1e-12
_BIG = 1e18


def log10_choose(n: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """log10(n choose k), batched, valid for real-valued n >= k >= 0."""
    n = torch.as_tensor(n, dtype=torch.float32)
    k = torch.as_tensor(k, dtype=torch.float32, device=n.device)
    return (torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0) - torch.lgamma(n - k + 1.0)) / math.log(10.0)


def sample_minimal(
    generator: torch.Generator,
    n: int,
    sample_size: int,
    n_hyps: int,
    valid: torch.Tensor | None = None,
    device=None,
) -> torch.Tensor:
    """Draw n_hyps index sets of size sample_size without replacement, from
    `generator`, with leading dimensions as `valid`'s (..., n).

    Invalid entries get ~zero probability. Returns (..., n_hyps, sample_size).
    Gumbel top-k gives sampling without replacement, fully batched.
    """
    if valid is None:
        lead, logits = (), torch.zeros((n,), dtype=torch.float32, device=device)
    else:
        lead = tuple(valid.shape[:-1])
        logits = torch.where(valid, 0.0, -1e9).to(torch.float32)
    dev = logits.device
    u = torch.rand(lead + (n_hyps, n), generator=generator, dtype=torch.float32, device=dev)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny))) + logits[..., None, :]
    _, idx = torch.topk(g, sample_size, dim=-1)
    return idx


class ACRansacSelection(NamedTuple):
    best_hyp: torch.Tensor  # (...) int64 — index of winning hypothesis
    best_nfa: torch.Tensor  # (...) float — its NFA (log10 units)
    threshold_sq: torch.Tensor  # (...) adaptive squared-residual threshold
    inliers: torch.Tensor  # (..., N) bool — inliers of the winning hypothesis
    n_inliers: torch.Tensor  # (...) int64


def _take_hyp(x: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """x (..., H, N) at the (...) hypothesis indices -> (..., N)."""
    idx = best[..., None, None].expand(best.shape + (1, x.shape[-1]))
    return torch.gather(x, -2, idx)[..., 0, :]


def acransac_select(
    res_sq: torch.Tensor,
    sample_size: int,
    logalpha0: float,
    mult_error: float = 0.5,
    valid: torch.Tensor | None = None,
    n_models_per_hyp: int = 1,
    max_threshold_sq: float = float("inf"),
) -> ACRansacSelection:
    """A-contrario selection over a batch of scored hypotheses.

    res_sq: (..., H, N) squared residuals of every datum under every
    hypothesis. valid: (..., N) mask of usable correspondences (padding ->
    False).
    """
    N = res_sq.shape[-1]
    dev = res_sq.device
    if valid is None:
        valid = torch.ones(res_sq.shape[:-2] + (N,), dtype=torch.bool, device=dev)
    nf = torch.sum(valid, dim=-1).to(torch.float32)  # (...)

    res = torch.where(valid[..., None, :], res_sq, torch.full_like(res_sq, _BIG))
    res = torch.where(torch.isfinite(res), res, torch.full_like(res, _BIG))
    res_sorted, _ = torch.sort(res, dim=-1)  # (..., H, N) ascending

    ks = torch.arange(1, N + 1, dtype=torch.float32, device=dev)  # candidate inlier counts
    loge0 = torch.log10(float(n_models_per_hyp) * torch.clamp(nf - sample_size, min=1.0))
    logc_n = log10_choose(nf[..., None], ks)  # (..., N)
    logc_k = log10_choose(ks, float(sample_size))
    logalpha = logalpha0 + mult_error * torch.log10(res_sorted + _EPS)
    nfa = (
        loge0[..., None, None]
        + logc_n[..., None, :]
        + logc_k
        + (ks - sample_size) * logalpha
    )  # (..., H, N)

    # Only k in (sample_size, n_valid] with residual under the cap counts.
    ok = (ks > sample_size) & (ks <= nf[..., None, None]) & (res_sorted <= max_threshold_sq)
    nfa = torch.where(ok, nfa, torch.full_like(nfa, math.inf))

    best_nfa_per_hyp, best_k_per_hyp = torch.min(nfa, dim=-1)  # (..., H)
    best_nfa, best_hyp = torch.min(best_nfa_per_hyp, dim=-1)  # (...)
    k_star = torch.gather(best_k_per_hyp, -1, best_hyp[..., None])  # (..., 1)
    thr = torch.gather(_take_hyp(res_sorted, best_hyp), -1, k_star)[..., 0]

    inliers = (_take_hyp(res_sq, best_hyp) <= thr[..., None]) & valid
    return ACRansacSelection(
        best_hyp=best_hyp,
        best_nfa=best_nfa,
        threshold_sq=thr,
        inliers=inliers,
        n_inliers=torch.sum(inliers, dim=-1),
    )


def simple_select(
    res_sq: torch.Tensor,
    threshold_sq: float,
    valid: torch.Tensor | None = None,
) -> ACRansacSelection:
    """Plain max-consensus selection at a fixed threshold
    (ref: robustEstimation/Ransac.hpp / maxConsensus.hpp)."""
    N = res_sq.shape[-1]
    if valid is None:
        valid = torch.ones(res_sq.shape[:-2] + (N,), dtype=torch.bool, device=res_sq.device)
    ok = (res_sq <= threshold_sq) & valid[..., None, :]
    counts = torch.sum(ok, dim=-1)
    best_n, best_hyp = torch.max(counts, dim=-1)
    return ACRansacSelection(
        best_hyp=best_hyp,
        best_nfa=-best_n.to(torch.float32),
        threshold_sq=torch.full(best_hyp.shape, threshold_sq, dtype=torch.float32, device=res_sq.device),
        inliers=_take_hyp(ok, best_hyp),
        n_inliers=best_n,
    )


def lmeds_select(
    res_sq: torch.Tensor,
    sample_size: int,
    valid: torch.Tensor | None = None,
) -> ACRansacSelection:
    """Least-median-of-squares selection (ref: robustEstimation/LMeds.hpp).

    Picks the hypothesis minimizing the median squared residual over valid
    data, then derives the classic LMedS inlier threshold from the robust
    scale estimate sigma = 1.4826 (1 + 5/(n - s)) sqrt(med).
    """
    N = res_sq.shape[-1]
    if valid is None:
        valid = torch.ones(res_sq.shape[:-2] + (N,), dtype=torch.bool, device=res_sq.device)
    n_valid = torch.sum(valid, dim=-1).to(torch.float32)
    res = torch.where(valid[..., None, :] & torch.isfinite(res_sq), res_sq, torch.full_like(res_sq, _BIG))
    res_sorted, _ = torch.sort(res, dim=-1)
    # Median over the *valid* prefix: index floor(n_valid / 2).
    med_idx = torch.clamp((n_valid / 2.0).to(torch.int64), 0, N - 1)
    med = torch.gather(res_sorted, -1, med_idx[..., None, None].expand(res_sorted.shape[:-1] + (1,)))[..., 0]
    med_best, best_hyp = torch.min(med, dim=-1)
    sigma = 1.4826 * (1.0 + 5.0 / torch.clamp(n_valid - sample_size, min=1.0)) * torch.sqrt(
        torch.clamp(med_best, min=0.0)
    )
    thr = (2.5 * sigma) ** 2
    inliers = (_take_hyp(res_sq, best_hyp) <= thr[..., None]) & valid
    return ACRansacSelection(
        best_hyp=best_hyp,
        best_nfa=med_best,
        threshold_sq=thr,
        inliers=inliers,
        n_inliers=torch.sum(inliers, dim=-1),
    )


# Model-dependent alpha0 constants (probability that a random point falls
# within distance r of the model), matching the reference kernels:
#   point-to-line (F/E epipolar):  alpha0 = 2 r diam / area, mult = 0.5
#   point-to-point (H, resection): alpha0 = pi r^2 / area,  mult = 1.0


def logalpha0_line(w: float, h: float) -> float:
    area = w * h
    diam = math.sqrt(w * w + h * h)
    return math.log10(2.0 * diam / area)


def logalpha0_point(w: float, h: float) -> float:
    return math.log10(math.pi / (w * h))
