"""Global color harmonization across views.

Port of `alicevision_tpu/misc/color_harmonization.py`: the IRLS solve runs
on the device, `patch_means` and `matched_quantile_constraints` stay host
numpy as there (copied). Counterpart of the reference's colorHarmonization
module (ref: src/aliceVision/colorHarmonization/GainOffsetConstraintBuilder.cpp
— per-view gain/offset consistency solved as an LP per [Moulon13]). The LP
is replaced by a robust (IRLS) least squares on the same pairwise
constraints: gain_i * m_i + offset_i = gain_j * m_j + offset_j for matched
color stats.

The normal matrix carries a 10 sqrt(E) gauge row beside IRLS weights up to
1/1e-2, so it is badly conditioned (cond ~4e4-6e4 on a few views): two
float32 evaluations of it differ by up to ~eps32 cond. On a card the IRLS
runs in float64, its normal equations formed and solved so
(`numeric.solve64`; ROADMAP §3: small ill-conditioned systems in float64
on a card); on the CPU in float32, as the JAX package runs it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..numeric import solve64


def _precision(dev: torch.device):
    """(dtype, solve) of the IRLS: float64 on a card, float32 on the CPU."""
    return (torch.float64, solve64) if dev.type == "cuda" else (torch.float32, torch.linalg.solve)


def harmonize_gains(
    n_views: int,
    edges: np.ndarray,  # (E, 2) view pairs
    mean_i,  # (E,) mean matched intensity in view i
    mean_j,  # (E,) same region seen in view j
    irls_iters: int = 3,
    ref_view: int = 0,
    device="cuda",
):
    """Solve per-view (gain, offset) making matched regions agree.

    Returns (gains (V,), offsets (V,)) float32 tensors on `device`, with the
    reference view fixed at identity (the LP's gauge constraint).
    """
    dev = resolve_device(device)
    dt, solve = _precision(dev)
    E = len(edges)
    edges = np.asarray(edges)
    ii = torch.as_tensor(edges[:, 0], dtype=torch.int64, device=dev)
    jj = torch.as_tensor(edges[:, 1], dtype=torch.int64, device=dev)
    mean_i = torch.as_tensor(np.asarray(mean_i, np.float32), device=dev).to(dt)
    mean_j = torch.as_tensor(np.asarray(mean_j, np.float32), device=dev).to(dt)
    rows = torch.arange(E, device=dev)
    n_unk = 2 * n_views
    big = float(np.float32(10.0) * np.sqrt(np.float32(E)))  # float32, as JAX rounds it

    def solve_w(w):
        # unknowns x = [g_0..g_V-1, o_0..o_V-1]
        A = torch.zeros((E + 2, n_unk), dtype=dt, device=dev)
        A.index_put_((rows, ii), w * mean_i, accumulate=True)
        A.index_put_((rows, n_views + ii), w, accumulate=True)
        A.index_put_((rows, jj), -w * mean_j, accumulate=True)
        A.index_put_((rows, n_views + jj), -w, accumulate=True)
        b = torch.zeros(E + 2, dtype=dt, device=dev)
        A[E, ref_view] = big
        b[E] = big  # g_ref = 1
        A[E + 1, n_views + ref_view] = big  # o_ref = 0
        x = solve(A.T @ A + 1e-9 * torch.eye(n_unk, dtype=dt, device=dev), A.T @ b)
        return x[:n_views], x[n_views:]

    g, o = solve_w(torch.ones(E, dtype=dt, device=dev))
    for _ in range(irls_iters):
        r = (g[ii] * mean_i + o[ii]) - (g[jj] * mean_j + o[jj])
        g, o = solve_w(1.0 / (torch.abs(r) + 1e-2))
    return g.float(), o.float()


def patch_means(img: np.ndarray, xy: np.ndarray, radius: int = 4) -> np.ndarray:
    """Mean intensity of the (2r+1)^2 patch around each keypoint, via an
    integral image (vectorized; no per-keypoint loops)."""
    img = np.asarray(img, np.float64)
    H, W = img.shape
    ii = np.zeros((H + 1, W + 1))
    ii[1:, 1:] = np.cumsum(np.cumsum(img, 0), 1)
    x = np.clip(np.round(np.asarray(xy)[:, 0]).astype(np.int64), 0, W - 1)
    y = np.clip(np.round(np.asarray(xy)[:, 1]).astype(np.int64), 0, H - 1)
    x0 = np.clip(x - radius, 0, W)
    x1 = np.clip(x + radius + 1, 0, W)
    y0 = np.clip(y - radius, 0, H)
    y1 = np.clip(y + radius + 1, 0, H)
    s = ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]
    area = np.maximum((y1 - y0) * (x1 - x0), 1)
    return s / area


def matched_quantile_constraints(
    img_i: np.ndarray,
    img_j: np.ndarray,
    xy_i: np.ndarray,  # (M, 2) matched keypoint positions in view i
    xy_j: np.ndarray,  # (M, 2) the same scene points in view j
    radius: int = 4,
    quantiles=(0.1, 0.25, 0.5, 0.75, 0.9),
):
    """Histogram-style constraints from the MATCHED region of a view pair
    (ref: colorHarmonization/GainOffsetConstraintBuilder.cpp — the
    reference builds constraints from the histograms of the common region;
    here the common region is the set of matched-feature patches, whose
    per-point means correspond 1:1 across the pair, so corresponding
    quantiles must map onto each other under the gain/offset).

    Returns (q_i, q_j) arrays of len(quantiles)."""
    if len(xy_i) == 0:
        return np.zeros(0), np.zeros(0)
    s_i = patch_means(img_i, xy_i, radius)
    s_j = patch_means(img_j, xy_j, radius)
    qs = np.asarray(quantiles)
    return np.quantile(s_i, qs), np.quantile(s_j, qs)
