"""Depth-map filtering + dense point-cloud fusion.

Port of `alicevision_tpu/mvs/fusion.py` (ref:
src/aliceVision/fuseCut/Fuser.hpp:21-34 cross-view consistency filtering
used by main_depthMapFiltering.cpp:142-144, and fuseCut/PointCloud.hpp:44
createDensePointCloud used by main_meshing.cpp:400-401). Consistency checks
are projections of whole depth maps into neighbour views on the device of
the depth maps; the voxel-grid simplification runs on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

_EPS = 1e-6


def backproject_depth_map(depth: torch.Tensor, K: torch.Tensor, R: torch.Tensor, c: torch.Tensor):
    """Depth map (H, W) -> world points (H, W, 3). R, c: world->cam pose."""
    H, W = depth.shape
    ys = torch.arange(H, dtype=depth.dtype, device=depth.device)
    xs = torch.arange(W, dtype=depth.dtype, device=depth.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    x_cam = torch.stack(
        [
            (gx - K[0, 2]) / K[0, 0] * depth,
            (gy - K[1, 2]) / K[1, 1] * depth,
            depth,
        ],
        dim=-1,
    )
    return torch.einsum("ji,hwj->hwi", R, x_cam) + c  # R^T x + c


def project_points(X: torch.Tensor, K: torch.Tensor, R: torch.Tensor, c: torch.Tensor):
    """World points (..., 3) -> (pixel (..., 2), depth (...,))."""
    x_cam = torch.einsum("ij,...j->...i", R, X - c)
    z = x_cam[..., 2]
    zs = torch.where(torch.abs(z) < _EPS, torch.full_like(z, _EPS), z)
    u = K[0, 0] * x_cam[..., 0] / zs + K[0, 2]
    v = K[1, 1] * x_cam[..., 1] / zs + K[1, 2]
    return torch.stack([u, v], dim=-1), z


def _sample_nearest(img: torch.Tensor, uv: torch.Tensor, fill: float):
    H, W = img.shape
    # torch.round rounds half to even, as jnp.round does
    x = torch.round(uv[..., 0]).long()
    y = torch.round(uv[..., 1]).long()
    ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    lin = y.clamp(0, H - 1) * W + x.clamp(0, W - 1)
    v = img.reshape(-1).index_select(0, lin.reshape(-1)).reshape(lin.shape)
    return torch.where(ok, v, torch.full_like(v, fill)), ok


def _consistent_counts(depths, K, R, c, r, others, rel_tol):
    """How many of the views `others` confirm each pixel of view r."""
    Xw = backproject_depth_map(depths[r], K[r], R[r], c[r])  # (H, W, 3)
    counts = torch.zeros(depths.shape[1:], dtype=torch.int32, device=depths.device)
    for o in others:
        uv, z_proj = project_points(Xw, K[o], R[o], c[o])
        d_other, inside = _sample_nearest(depths[o], uv, -1.0)
        counts += (
            inside
            & (d_other > 0)
            & (torch.abs(d_other - z_proj) < rel_tol * z_proj)
            & (z_proj > 0)
        )
    return counts


def _keep(depths, r, counts, min_consistent):
    valid = (depths[r] > 0) & (counts + 1 >= min_consistent)
    return torch.where(valid, depths[r], torch.full_like(depths[r], -1.0))


def consistency_filter(
    depths: torch.Tensor,  # (V, H, W) per-view depth maps (<=0 = invalid)
    K: torch.Tensor,  # (V, 3, 3)
    R: torch.Tensor,  # (V, 3, 3) world->cam
    c: torch.Tensor,  # (V, 3)
    min_consistent: int = 3,
    rel_tol: float = 0.01,
):
    """Keep pixels whose depth reprojects consistently into enough other
    views (Fuser::filterDepthMaps semantics). Returns filtered (V, H, W)
    with inconsistent pixels set to -1, plus the consistency counts."""
    V = depths.shape[0]
    filt, counts = [], []
    for r in range(V):
        cnt = _consistent_counts(
            depths, K, R, c, r, [o for o in range(V) if o != r], rel_tol
        )
        filt.append(_keep(depths, r, cnt, min_consistent))
        counts.append(cnt)
    return torch.stack(filt), torch.stack(counts)


def _ring_offsets(V: int, k: int):
    """Distinct ring-neighbour offsets ±1..±k_eff, capped so wraparound
    never double-counts a view and never includes self. For even V at
    k >= V/2 the antipodal view (+V/2 ≡ −V/2) is included exactly once,
    so the window degenerates to the dense all-pairs set."""
    k_pos = min(int(k), V // 2)
    k_neg = k_pos if 2 * k_pos < V else k_pos - 1
    return [o for o in range(-k_neg, k_pos + 1) if o != 0]


def consistency_filter_ring(
    depths: torch.Tensor,  # (V, H, W) per-view depth maps (<=0 = invalid)
    K: torch.Tensor,  # (V, 3, 3)
    R: torch.Tensor,  # (V, 3, 3) world->cam
    c: torch.Tensor,  # (V, 3)
    k: int = 4,
    min_consistent: int = 3,
    rel_tol: float = 0.01,
):
    """`consistency_filter` restricted to the ±k adjacent views in capture
    order (with wraparound), the bounded consistency set of the reference
    (ref: src/aliceVision/fuseCut/Fuser.hpp:21-34)."""
    V = depths.shape[0]
    offs = _ring_offsets(V, k)
    filt, counts = [], []
    for r in range(V):
        cnt = _consistent_counts(
            depths, K, R, c, r, [(r + off) % V for off in offs], rel_tol
        )
        filt.append(_keep(depths, r, cnt, min_consistent))
        counts.append(cnt)
    return torch.stack(filt), torch.stack(counts)


def fuse_point_cloud(
    depths: np.ndarray,  # (V, H, W) filtered depth maps
    colors: np.ndarray | None,  # (V, H, W, 3) or None
    K: np.ndarray,
    R: np.ndarray,
    c: np.ndarray,
    sim: np.ndarray | None = None,  # (V, H, W) similarity, optional weight
    voxel_size: float = 0.0,
    device="cuda",
):
    """Fuse all valid depth pixels into one world-space cloud (+ colors,
    + per-point view id), with optional voxel-grid simplification
    (PointCloud::createDensePointCloud's voxel filtering). Host arrays in
    and out; the back-projection runs on `device`."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    pts_all, col_all, view_all = [], [], []
    for v in range(depths.shape[0]):
        d = depths[v]
        m = d > 0
        if not m.any():
            continue
        Xw = backproject_depth_map(t(d), t(K[v]), t(R[v]), t(c[v])).cpu().numpy()
        pts_all.append(Xw[m])
        view_all.append(np.full(int(m.sum()), v, np.int32))
        if colors is not None:
            col_all.append(colors[v][m])
    if not pts_all:
        return (
            np.zeros((0, 3)),
            np.zeros((0, 3), np.uint8),
            np.zeros(0, np.int32),
        )
    pts = np.concatenate(pts_all)
    views = np.concatenate(view_all)
    cols = (
        np.concatenate(col_all)
        if colors is not None
        else np.full((len(pts), 3), 255, np.uint8)
    )

    if voxel_size > 0:
        keys = np.floor(pts / voxel_size).astype(np.int64)
        # hash voxel coords; keep first point per voxel
        h = keys[:, 0] * 73856093 ^ keys[:, 1] * 19349663 ^ keys[:, 2] * 83492791
        _, first = np.unique(h, return_index=True)
        pts, cols, views = pts[first], cols[first], views[first]
    return pts, cols, views


def depth_range_from_landmarks(
    points: np.ndarray, R: np.ndarray, c: np.ndarray, margin: float = 0.2
):
    """Per-view (d_min, d_max) from SfM landmark depths
    (SgmDepthList.cpp:48-75 derives hypotheses from landmarks)."""
    x_cam = (R @ (points - c).T).T
    z = x_cam[:, 2]
    z = z[z > 0]
    if len(z) == 0:
        return 0.1, 100.0
    lo, hi = np.percentile(z, [2, 98])
    span = hi - lo
    return float(max(lo - margin * span, 1e-3)), float(hi + margin * span)
