"""Descriptor matching: brute force and cascade hashing, ratio test.

Port of `alicevision_tpu/matching/descriptor_matching.py` (ref:
src/aliceVision/matching/ArrayMatcher_bruteForce.hpp,
CascadeHasher.hpp:64-104, filters.hpp distance-ratio, guidedMatching.hpp).

The exact L2 top-2 search is a matrix product plus `torch.topk`. The
product runs in full float32 (`f32_matmuls`: with TF32 the distances lose
about three digits and the ratio test flips). Every function takes
fixed-capacity descriptor tensors with validity masks and returns
fixed-size match tables (index into the second set, -1 = no match);
`match_bruteforce` also takes leading batch dimensions, (B, N, D) against
(B, M, D), so that a chunk of image pairs is one call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..numeric import f32_matmuls

_BIG = 1e9


class Matches(NamedTuple):
    idx2: torch.Tensor  # (..., N) int32 — match of descriptor i in set 2, -1 = none
    dist: torch.Tensor  # (..., N) float32 — L2^2 distance of the accepted match


def _pairwise_sqdist(d1, d2):
    """||a-b||^2 via the matmul identity, float32 accumulation."""
    n1 = torch.sum(d1 * d1, dim=-1, keepdim=True)
    n2 = torch.sum(d2 * d2, dim=-1, keepdim=True)
    cross = torch.matmul(d1, d2.transpose(-1, -2))
    return torch.clamp(n1 + n2.transpose(-1, -2) - 2.0 * cross, min=0.0)


def _ratio_matches(dist, valid1, ratio, cross_check):
    """Top-2 of each row of `dist` (..., N, M), Lowe's ratio test on squared
    distances, and optionally the mutual-best check."""
    top2, idx_top2 = torch.topk(dist, 2, dim=-1, largest=False)
    best = idx_top2[..., 0]
    d_best = top2[..., 0]
    d_second = top2[..., 1]
    ok = valid1 & (d_best < (ratio * ratio) * d_second) & (d_best < _BIG)
    if cross_check:
        dist_t = torch.where(valid1[..., :, None], dist, torch.full_like(dist, _BIG))
        back = torch.argmin(dist_t, dim=-2)  # (..., M) best row for each column
        rows = torch.arange(dist.shape[-2], device=dist.device)
        ok = ok & (torch.gather(back, -1, best) == rows)
    return Matches(
        idx2=torch.where(ok, best, torch.full_like(best, -1)).to(torch.int32),
        dist=torch.where(ok, d_best, torch.full_like(d_best, _BIG)),
    )


@f32_matmuls
def match_bruteforce(
    d1: torch.Tensor,
    d2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    ratio: float = 0.8,
    cross_check: bool = True,
) -> Matches:
    """Exact top-2 NN with Lowe ratio filtering.

    d1: (..., N, D), d2: (..., M, D) float descriptors; returns per-row
    matches.
    """
    dist = _pairwise_sqdist(d1, d2)
    dist = torch.where(valid2[..., None, :], dist, torch.full_like(dist, _BIG))
    return _ratio_matches(dist, valid1, ratio, cross_check)


def match_bruteforce_hamming(
    d1: torch.Tensor,
    d2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    ratio: float = 0.8,
    cross_check: bool = True,
) -> Matches:
    """BRUTE_FORCE_HAMMING for binary descriptors stored as {0,1} floats
    (ref: matching/matcherType.hpp). For 0/1 vectors the squared-L2
    distance equals the Hamming distance, so the brute-force product gives
    exact Hamming top-2; the returned dist is the Hamming distance."""
    return match_bruteforce(d1, d2, valid1, valid2, ratio, cross_check)


def match_ann_l2(d1, d2, valid1, valid2, ratio: float = 0.8) -> Matches:
    """ANN_L2 — approximate NN via a host-side kd-tree
    (ref: matching/ArrayMatcher_kdtreeFlann.hpp), for CPU-only hosts
    driving very large descriptor sets. Returns CPU tensors."""
    from scipy.spatial import cKDTree

    def host(x, dtype):
        return x.detach().cpu().numpy().astype(dtype) if torch.is_tensor(x) else np.asarray(x, dtype)

    d1, d2 = host(d1, np.float32), host(d2, np.float32)
    v1, v2 = host(valid1, bool), host(valid2, bool)
    idx2 = np.nonzero(v2)[0]
    out_idx = np.full(len(d1), -1, np.int32)
    out_dist = np.full(len(d1), _BIG, np.float32)
    if len(idx2) >= 2 and v1.any():
        tree = cKDTree(d2[idx2])
        dd, ii = tree.query(d1[v1], k=2)
        best = idx2[ii[:, 0]]
        ok = dd[:, 0] ** 2 < (ratio * ratio) * dd[:, 1] ** 2
        rows = np.nonzero(v1)[0]
        out_idx[rows[ok]] = best[ok]
        out_dist[rows[ok]] = (dd[ok, 0] ** 2).astype(np.float32)
    return Matches(idx2=torch.from_numpy(out_idx), dist=torch.from_numpy(out_dist))


def make_hash_projection(generator: torch.Generator, dim: int = 128, bits: int = 128, device="cpu") -> torch.Tensor:
    """Random Gaussian projection for the primary hash
    (ref: CascadeHasher.hpp:80 — 128-bit primary hash), drawn from
    `generator` (which lives on `device`)."""
    return torch.randn((dim, bits), generator=generator, dtype=torch.float32, device=device)


def _top_k_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis with ties in index order, as `lax.top_k`
    orders them (hamming dot products are small integers, so ties are the
    rule there)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@f32_matmuls
def match_cascade_hash(
    d1: torch.Tensor,
    d2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    proj: torch.Tensor,
    mean: torch.Tensor,
    ratio: float = 0.8,
    n_candidates: int = 64,
) -> Matches:
    """Two-stage cascade-hash matching.

    Stage 1: 128-bit sign hash of (desc - mean) @ proj; hamming distances
    computed as a ±1 product. Stage 2: exact L2 top-2 re-rank over the
    n_candidates best hamming candidates per query.
    """
    s1 = torch.sign((d1 - mean) @ proj)  # (N, B) in {-1, 0, 1}
    s2 = torch.sign((d2 - mean) @ proj)
    # hamming = (B - dot)/2 — monotone in -dot, so rank by dot directly.
    dots = s1 @ s2.T
    dots = torch.where(valid2[None, :], dots, torch.full_like(dots, -1e9))
    _, cand = _top_k_stable(dots, n_candidates)  # (N, C)

    d2c = d2[cand]  # (N, C, D)
    diff = d1[:, None, :] - d2c
    dist = torch.sum(diff * diff, dim=-1)  # (N, C)
    dist = torch.where(valid2[cand], dist, torch.full_like(dist, _BIG))
    top2, it2 = torch.topk(dist, 2, dim=-1, largest=False)
    best = torch.gather(cand, 1, it2[:, :1])[:, 0]
    d_best = top2[:, 0]
    d_second = top2[:, 1]
    ok = valid1 & (d_best < (ratio * ratio) * d_second) & (d_best < _BIG)
    return Matches(
        idx2=torch.where(ok, best, torch.full_like(best, -1)).to(torch.int32),
        dist=torch.where(ok, d_best, torch.full_like(d_best, _BIG)),
    )


def _banded_matches(band, d1, d2, valid1, valid2, ratio):
    dist = _pairwise_sqdist(d1, d2)
    dist = torch.where(band & valid2[None, :], dist, torch.full_like(dist, _BIG))
    return _ratio_matches(dist, valid1, ratio, cross_check=False)


@f32_matmuls
def guided_match_epipolar(
    F: torch.Tensor,
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    d1: torch.Tensor,
    d2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    max_epipolar_px: float = 4.0,
    ratio: float = 0.8,
) -> Matches:
    """Descriptor matching restricted to an epipolar band
    (ref: matching/guidedMatching.hpp — GeometricFilter functor for F).

    Candidates outside the band get infinite distance; otherwise exact L2.
    """
    ones1 = torch.ones((xy1.shape[0], 1), dtype=xy1.dtype, device=xy1.device)
    p1 = torch.cat([xy1, ones1], dim=-1)
    l2 = p1 @ F.T  # (N, 3) epipolar lines in image 2
    num = (l2[:, None, 0] * xy2[None, :, 0] + l2[:, None, 1] * xy2[None, :, 1] + l2[:, None, 2]) ** 2
    den = (l2[:, 0] ** 2 + l2[:, 1] ** 2)[:, None].clamp(min=1e-12)
    band = num / den <= max_epipolar_px**2  # (N, M)
    return _banded_matches(band, d1, d2, valid1, valid2, ratio)


@f32_matmuls
def guided_match_homography(
    H: torch.Tensor,
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    d1: torch.Tensor,
    d2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    max_transfer_px: float = 4.0,
    ratio: float = 0.8,
) -> Matches:
    """Descriptor matching restricted to a homography transfer disc
    (ref: matching/guidedMatching.hpp — the H-model functor)."""
    ones1 = torch.ones((xy1.shape[0], 1), dtype=xy1.dtype, device=xy1.device)
    p1 = torch.cat([xy1, ones1], dim=-1)
    Hp = p1 @ H.T
    z = torch.where(torch.abs(Hp[:, 2:]) < 1e-12, torch.full_like(Hp[:, 2:], 1e-12), Hp[:, 2:])
    proj = Hp[:, :2] / z  # (N, 2) predicted positions in image 2
    d2sq = torch.sum((proj[:, None, :] - xy2[None, :, :]) ** 2, dim=-1)
    band = d2sq <= max_transfer_px**2
    return _banded_matches(band, d1, d2, valid1, valid2, ratio)


def matches_to_pairs(matches: Matches) -> np.ndarray:
    """Host helper: (N,) match table -> (K, 2) index pairs (numpy)."""
    idx2 = matches.idx2.cpu().numpy() if torch.is_tensor(matches.idx2) else np.asarray(matches.idx2)
    rows = np.nonzero(idx2 >= 0)[0]
    return np.stack([rows, idx2[rows]], axis=-1)
