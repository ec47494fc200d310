"""Texturing: best-view selection + per-vertex color baking.

Port of `bake_vertex_colors` of `alicevision_tpu/mesh/texturing.py` (ref:
src/aliceVision/mesh/Texturing.hpp:75, Texturing::generateTextures'
[Waechter2014]-style best-view scoring). Host numpy, copied; the UV-atlas
half of the reference module is not ported.
"""

from __future__ import annotations

import numpy as np

from .ops import vertex_normals


def bake_vertex_colors(
    vertices: np.ndarray,  # (V, 3)
    faces: np.ndarray,  # (F, 3)
    images: list,  # per view (H, W) or (H, W, 3) float arrays
    K: np.ndarray,  # (C, 3, 3)
    R: np.ndarray,  # (C, 3, 3) world->cam
    c: np.ndarray,  # (C, 3)
    depth_maps: list | None = None,  # optional per-view (H, W) for occlusion
    depth_tol: float = 0.02,
) -> np.ndarray:
    """Color each vertex from its best-scoring observing view.

    Score = cos(angle between view ray and vertex normal) / distance^2 — the
    [Waechter2014]-inspired quality heuristic of the reference. Occlusion is
    tested against the per-view depth maps when provided.
    Returns (V, 3) uint8 colors.
    """
    Vn = vertex_normals(vertices, faces)
    n_views = len(images)
    best_score = np.full(len(vertices), -np.inf)
    colors = np.full((len(vertices), 3), 0.5, np.float64)  # [0,1] scale

    for v in range(n_views):
        x_cam = (R[v] @ (vertices - c[v]).T).T
        z = x_cam[:, 2]
        ok = z > 1e-6
        u = K[v][0, 0] * x_cam[:, 0] / np.where(ok, z, 1) + K[v][0, 2]
        w = K[v][1, 1] * x_cam[:, 1] / np.where(ok, z, 1) + K[v][1, 2]
        img = images[v]
        H, W = img.shape[:2]
        ok &= (u >= 0) & (u < W - 1) & (w >= 0) & (w < H - 1)

        view_dir = (c[v] - vertices)
        dist = np.linalg.norm(view_dir, axis=-1)
        view_dir /= np.maximum(dist[:, None], 1e-12)
        cosang = np.sum(view_dir * Vn, axis=-1)
        score = np.where(ok & (cosang > 0.1), cosang / np.maximum(dist, 1e-6) ** 2, -np.inf)

        if depth_maps is not None and depth_maps[v] is not None:
            d = depth_maps[v]
            ui = np.clip(u.astype(int), 0, W - 1)
            wi = np.clip(w.astype(int), 0, H - 1)
            dsamp = d[wi, ui]
            visible = (dsamp > 0) & (np.abs(dsamp - z) < depth_tol * z)
            score = np.where(visible, score, -np.inf)

        upd = score > best_score
        if not upd.any():
            continue
        ui = np.clip(u[upd].astype(int), 0, W - 2)
        wi = np.clip(w[upd].astype(int), 0, H - 2)
        fu = (u[upd] - ui)[:, None] if img.ndim == 3 else (u[upd] - ui)
        fw = (w[upd] - wi)[:, None] if img.ndim == 3 else (w[upd] - wi)
        val = (
            img[wi, ui] * (1 - fu) * (1 - fw)
            + img[wi, ui + 1] * fu * (1 - fw)
            + img[wi + 1, ui] * (1 - fu) * fw
            + img[wi + 1, ui + 1] * fu * fw
        )
        if img.ndim == 2:
            val = np.stack([val, val, val], axis=-1)
        colors[upd] = val[..., :3]
        best_score[upd] = score[upd]

    return np.clip(colors * 255.0, 0, 255).astype(np.uint8)
