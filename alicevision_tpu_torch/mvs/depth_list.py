"""Per-view SGM depth hypothesis lists from SfM landmarks.

Host numpy copy of `alicevision_tpu/mvs/depth_list.py` (ref:
src/aliceVision/depthMap/SgmDepthList.cpp:48-178 computeListRc,
:272-340 getMinMaxMidNbDepthFromSfM): the depth range of an R camera comes
from the landmarks IT OBSERVES (optionally restricted to a tile ROI),
trimmed to a percentile and inflated by a margin; every T camera then gets
an index sub-range of the shared depth grid covering only the depths whose
principal-ray point is visible in that T camera (depthsTcLimits).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class DepthList(NamedTuple):
    depths: np.ndarray  # (D,) increasing, uniform in INVERSE depth
    tc_limits: np.ndarray  # (T, 2) [lo, hi) index range per T camera
    d_min: float
    d_max: float
    n_obs: int  # landmarks used


def view_depth_range(
    points: np.ndarray,  # (L, 3) landmarks
    obs_landmark: np.ndarray,  # (O,) landmark index per observation
    obs_view: np.ndarray,  # (O,) view index per observation
    obs_uv: np.ndarray,  # (O, 2) full-size pixel observation
    rc: int,
    R: np.ndarray,  # (3, 3) world->cam of rc
    c: np.ndarray,  # (3,)
    roi: Optional[tuple] = None,  # (x0, y0, x1, y1) full-size pixels
    percentile: float = 0.999,  # SgmParams seedsRangePercentile
    inflate: float = 0.2,  # SgmParams seedsRangeInflate
):
    """(d_min, d_max, n_obs) from the landmarks rc observes (in the ROI)."""
    sel = obs_view == rc
    if roi is not None:
        x0, y0, x1, y1 = roi
        uv = obs_uv
        sel = (
            sel
            & (uv[:, 0] >= x0)
            & (uv[:, 0] < x1)
            & (uv[:, 1] >= y0)
            & (uv[:, 1] < y1)
        )
    lids = np.unique(obs_landmark[sel])
    if len(lids) < 2:
        return None
    z = (points[lids] - c) @ R[2]
    z = z[z > 1e-6]
    if len(z) < 2:
        return None
    lo = np.quantile(z, 1.0 - percentile)
    hi = np.quantile(z, percentile)
    margin = inflate * (hi - lo)
    return float(max(lo - margin, 1e-6)), float(hi + margin), int(len(z))


def _tc_visible_range(depths, K_ref, hw_ref, K_t, hw_t, R_rel, t_rel):
    """Index range of `depths` whose principal-ray point projects inside
    the T camera (the computeRcTcDepths visibility criterion)."""
    w, h = hw_ref
    x = (w / 2.0 - K_ref[0, 2]) / K_ref[0, 0]
    y = (h / 2.0 - K_ref[1, 2]) / K_ref[1, 1]
    ray = np.array([x, y, 1.0])
    pts = depths[:, None] * ray[None, :]  # (D, 3) in rc frame
    xt = pts @ R_rel.T + t_rel
    z = xt[:, 2]
    ok = z > 1e-6
    zs = np.where(ok, z, 1.0)
    u = K_t[0, 0] * xt[:, 0] / zs + K_t[0, 2]
    v = K_t[1, 1] * xt[:, 1] / zs + K_t[1, 2]
    wt, ht = hw_t
    vis = ok & (u >= 0) & (u < wt) & (v >= 0) & (v < ht)
    idx = np.nonzero(vis)[0]
    if len(idx) == 0:
        return 0, len(depths)  # degenerate: sweep everything
    return int(idx[0]), int(idx[-1]) + 1


def sgm_depth_list(
    points: np.ndarray,
    obs_landmark: np.ndarray,
    obs_view: np.ndarray,
    obs_uv: np.ndarray,
    rc: int,
    R_all: dict,
    c_all: dict,
    K_all: dict,
    hw_all: dict,  # view -> (w, h) at PROCESSING scale; obs_uv full-size
    tcams: list,
    n_depths: int,
    roi: Optional[tuple] = None,
    percentile: float = 0.999,
    inflate: float = 0.2,
    fallback_range=(0.1, 100.0),
) -> DepthList:
    """Full depth list for one R camera: observed-landmark range +
    uniform-inverse-depth grid capped at n_depths + per-T-cam limits."""
    rng = view_depth_range(
        points, obs_landmark, obs_view, obs_uv, rc,
        R_all[rc], c_all[rc], roi=roi,
        percentile=percentile, inflate=inflate,
    )
    if rng is None:
        d_min, d_max, n_obs = fallback_range[0], fallback_range[1], 0
    else:
        d_min, d_max, n_obs = rng
    inv = np.linspace(1.0 / d_max, 1.0 / d_min, n_depths)
    depths = (1.0 / inv)[::-1].copy()  # increasing depth

    R_rc, c_rc = R_all[rc], c_all[rc]
    limits = np.zeros((len(tcams), 2), np.int32)
    for i, t in enumerate(tcams):
        R_rel = R_all[t] @ R_rc.T
        t_rel = R_all[t] @ (c_rc - c_all[t])
        limits[i] = _tc_visible_range(
            depths, K_all[rc], hw_all[rc], K_all[t], hw_all[t], R_rel, t_rel
        )
    return DepthList(depths, limits, d_min, d_max, n_obs)
