"""Camera-frustum intersection for pair selection.

Port of `alicevision_tpu/sfm/frustum.py`, the counterpart of the
reference's frustum filtering (ref: src/aliceVision/sfm/FrustumFilter.cpp,
geometry/Frustum.hpp: exact convex-polytope intersection per pair, looped
on the CPU). The frusta of all posed views are one (V, 8, 3) corner tensor
and the separating-axis test runs batched over the V(V-1)/2 pairs: the
candidate axes are the face normals and side-edge cross products of both
frusta, exact for convex polyhedra.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..numeric import f32_matmuls
from ..sfmdata.scene import SfMData


@f32_matmuls
def frustum_corners(K, R, c, wh, z_near: float, z_far: float) -> torch.Tensor:
    """8 world-space corners of a view frustum. K (3,3), R (3,3) world->cam,
    c (3,), wh (2,). Rows 0-3 near plane, 4-7 far plane (x then y order)."""
    w, h = wh[0], wh[1]
    zero = torch.zeros_like(w)
    pix = torch.stack([torch.stack([zero, zero]), torch.stack([w, zero]), torch.stack([w, h]),
                       torch.stack([zero, h])])
    rays = torch.cat([pix, torch.ones_like(pix[:, :1])], dim=-1) @ torch.linalg.inv(K).T  # (4, 3) camera
    cam_pts = torch.cat([rays * z_near, rays * z_far], dim=0)  # (8, 3)
    return cam_pts @ R + c  # Rᵀ x + c, world frame


def _frustum_axes(corners: torch.Tensor):
    """Face normals (5) and side edge directions (4) of frusta (..., 8, 3)."""
    nears = [corners[..., i, :] for i in range(4)]
    fars = [corners[..., 4 + i, :] for i in range(4)]
    # side planes: each holds edge (n_i -> f_i) and edge (n_i -> n_{i+1})
    sides = [torch.linalg.cross(nears[(i + 1) % 4] - nears[i], fars[i] - nears[i], dim=-1) for i in range(4)]
    far_normal = torch.linalg.cross(fars[1] - fars[0], fars[3] - fars[0], dim=-1)
    edges = torch.stack([fars[i] - nears[i] for i in range(4)], dim=-2)
    return torch.stack(sides + [far_normal], dim=-2), edges


@f32_matmuls
def _sat_disjoint(ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """True where a separating axis exists between corner sets (P, 8, 3)."""
    fa, ea = _frustum_axes(ca)
    fb, eb = _frustum_axes(cb)
    cross = torch.linalg.cross(ea[..., :, None, :].expand(ea.shape[:-2] + (4, 4, 3)),
                               eb[..., None, :, :].expand(eb.shape[:-2] + (4, 4, 3)), dim=-1)
    axes = torch.cat([fa, fb, cross.flatten(-3, -2)], dim=-2)  # (P, 26, 3)
    norm = torch.linalg.norm(axes, dim=-1, keepdim=True)
    axes = axes / torch.where(norm < 1e-12, torch.ones_like(norm), norm)
    pa = ca @ axes.transpose(-1, -2)  # (P, 8, 26)
    pb = cb @ axes.transpose(-1, -2)
    degenerate = norm[..., 0] < 1e-12
    sep = (pa.amax(-2) < pb.amin(-2) - 1e-9) | (pb.amax(-2) < pa.amin(-2) - 1e-9)
    return torch.any(sep & ~degenerate, dim=-1)


def scene_frusta(scene: SfMData, z_near=None, z_far=None, device="cuda") -> tuple:
    """(view_indices, corners (V, 8, 3) on `device`) for all posed views.
    When the scene has structure, each view's depth range comes from its
    observed landmarks (as FrustumFilter.cpp:init derives near/far)."""
    dev = resolve_device(device)
    views = scene.valid_views()
    corners = []

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    for v in views:
        K, R, c = scene.camera_matrices(v)
        zn, zf = z_near, z_far
        if zn is None or zf is None:
            sel = scene.obs_view == v
            if np.any(sel):
                X = scene.points[scene.obs_landmark[sel]]
                z = (X - c) @ R[2]
                z = z[z > 0]
                if len(z):
                    zn = zn or max(float(np.percentile(z, 2)) * 0.8, 1e-3)
                    zf = zf or float(np.percentile(z, 98)) * 1.2
            zn = zn or 0.1
            zf = zf or 100.0
        corners.append(frustum_corners(t(K), t(R), t(c), t(scene.view_sizes[v]), zn, zf))
    return views, torch.stack(corners) if corners else torch.zeros((0, 8, 3), device=dev)


def frustum_pairs(scene: SfMData, z_near=None, z_far=None, device="cuda") -> np.ndarray:
    """All view pairs whose frusta intersect, as (P, 2) view indices
    (ref: FrustumFilter::getFrustumIntersectionPairs)."""
    views, corners = scene_frusta(scene, z_near, z_far, device=device)
    V = len(views)
    if V < 2:
        return np.zeros((0, 2), np.int64)
    ii, jj = torch.triu_indices(V, V, offset=1, device=corners.device)
    disjoint = _sat_disjoint(corners[ii], corners[jj]).cpu().numpy()
    keep = np.nonzero(~disjoint)[0]
    ii, jj = ii.cpu().numpy(), jj.cpu().numpy()
    return np.stack([views[ii[keep]], views[jj[keep]]], -1).astype(np.int64)
