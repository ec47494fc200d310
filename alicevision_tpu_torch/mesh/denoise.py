"""Mesh denoising, resampling and masking.

Port of `alicevision_tpu/mesh/denoise.py` (ref:
src/dependencies/MeshSDFilter — SD filter mesh denoising;
src/software/pipeline/main_meshDenoising.cpp, main_meshResampling.cpp,
main_meshMasking.cpp). The denoiser is the reference's two-stage recipe:
robust (bilateral) filtering of the face-normal field, then a vertex update
that re-integrates the filtered normals. Both stages are segment sums over
the face/vertex incidence, `index_add_` on `device` (the reference's
`.at[].add`; the card sums in another order, so the result agrees to
float32 rounding, not bit for bit). Resampling and masking are host numpy,
as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _face_geometry(x, faces):
    p0, p1, p2 = (x[faces[:, i]] for i in range(3))
    fn = torch.linalg.cross(p1 - p0, p2 - p0)
    area2 = torch.linalg.norm(fn, dim=-1, keepdim=True)
    n = fn / area2.clamp_min(1e-12)
    c = (p0 + p1 + p2) / 3.0
    return n, 0.5 * area2[:, 0], c


def _unit(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(1e-12)


def denoise_sd(
    vertices: np.ndarray,
    faces: np.ndarray,
    iterations: int = 8,
    sigma_n: float = 0.35,
    vertex_iters: int = 10,
    device="cuda",
) -> np.ndarray:
    """Bilateral normal filtering + normal re-integration.

    sigma_n is the bilateral range sigma on unit normals (||n_i - n_j||);
    smaller preserves sharper creases. Neighborhoods are faces sharing a
    vertex, realized as two segment ops through the vertex table (gather /
    scatter-add) instead of an explicit face-adjacency list.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(vertices), dtype=torch.float32, device=dev)
    f = torch.as_tensor(np.asarray(faces), dtype=torch.int64, device=dev)
    V = len(vertices)
    inv_2s2 = 1.0 / (2.0 * sigma_n * sigma_n)

    for _ in range(iterations):
        n, area, _ = _face_geometry(x, f)
        # Push area-weighted normals to vertices, then pull back to faces:
        # one smoothing pass whose support is the 1-ring of faces. The
        # bilateral weight is applied on the pull using the face's own
        # normal vs the vertex-aggregate direction.
        na = n * area[:, None]
        vn = torch.zeros((V, 3), device=dev)
        for i in range(3):
            vn.index_add_(0, f[:, i], na)
        pn = _unit((vn[f[:, 0]] + vn[f[:, 1]] + vn[f[:, 2]]) / 3.0)
        d2 = torch.sum((pn - n) ** 2, dim=-1, keepdim=True)
        w = torch.exp(-d2 * inv_2s2)
        nf = _unit(n * (1.0 - w) + pn * w)

        # Vertex update (Sun et al. 2007): move each vertex along the
        # filtered normals of its incident faces to satisfy n . (c - x) = 0.
        ones = torch.ones(len(f), device=dev)
        for _ in range(vertex_iters):
            _, _, c = _face_geometry(x, f)
            upd = torch.zeros((V, 3), device=dev)
            cnt = torch.zeros((V,), device=dev)
            for i in range(3):
                corr = torch.sum(nf * (c - x[f[:, i]]), dim=-1, keepdim=True) * nf
                upd.index_add_(0, f[:, i], corr)
                cnt.index_add_(0, f[:, i], ones)
            x = x + upd / cnt[:, None].clamp_min(1.0)
    return x.cpu().numpy()


def resample(
    vertices: np.ndarray,
    faces: np.ndarray,
    target_edge: float,
    smooth_iters: int = 3,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Approximately-uniform remeshing at the given edge length
    (ref: main_meshResampling.cpp contract). Long edges are midpoint-split
    (up to 3 rounds), the result is vertex-clustered at the target length
    and Taubin-relaxed on `device` — a simplification-based take on
    isotropic remeshing that preserves the surface to O(target_edge)."""
    from .ops import decimate_grid, laplacian_smooth

    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    for _ in range(3):
        e01 = np.linalg.norm(v[f[:, 0]] - v[f[:, 1]], axis=-1)
        e12 = np.linalg.norm(v[f[:, 1]] - v[f[:, 2]], axis=-1)
        e20 = np.linalg.norm(v[f[:, 2]] - v[f[:, 0]], axis=-1)
        long_face = np.maximum(np.maximum(e01, e12), e20) > 1.5 * target_edge
        if not long_face.any():
            break
        keep = f[~long_face]
        split = f[long_face]
        # 1->4 midpoint subdivision of long faces (shared midpoints merged
        # by the clustering pass below).
        m01 = 0.5 * (v[split[:, 0]] + v[split[:, 1]])
        m12 = 0.5 * (v[split[:, 1]] + v[split[:, 2]])
        m20 = 0.5 * (v[split[:, 2]] + v[split[:, 0]])
        base = len(v)
        k = len(split)
        i01 = base + np.arange(k)
        i12 = base + k + np.arange(k)
        i20 = base + 2 * k + np.arange(k)
        v = np.concatenate([v, m01, m12, m20])
        f = np.concatenate(
            [
                keep,
                np.stack([split[:, 0], i01, i20], 1),
                np.stack([i01, split[:, 1], i12], 1),
                np.stack([i20, i12, split[:, 2]], 1),
                np.stack([i01, i12, i20], 1),
            ]
        )
    # Weld duplicate midpoints + equalize density.
    v, f = decimate_grid(v, f, target_edge)
    if smooth_iters > 0 and len(f):
        x = torch.as_tensor(v, dtype=torch.float32, device=resolve_device(device))
        v = laplacian_smooth(x, f, iterations=smooth_iters).cpu().numpy()
    return v, f.astype(np.int32)


def mask_faces_by_views(
    vertices: np.ndarray,
    faces: np.ndarray,
    project_fns,
    masks,
    min_views: int = 1,
    invert: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """meshMasking: keep faces whose centroid lands inside the image mask in
    at least min_views views (ref: main_meshMasking.cpp contract).

    project_fns: list of callables X (N, 3) -> (uv (N, 2), depth (N,));
    masks: list of HxW bool arrays aligned with project_fns.
    """
    from .ops import compact

    c = vertices[faces].mean(axis=1)  # (F, 3)
    votes = np.zeros(len(faces), np.int32)
    for proj, m in zip(project_fns, masks):
        uv, depth = proj(c)
        h, wdt = m.shape[:2]
        xi = np.round(uv[:, 0]).astype(np.int64)
        yi = np.round(uv[:, 1]).astype(np.int64)
        inside = (depth > 0) & (xi >= 0) & (xi < wdt) & (yi >= 0) & (yi < h)
        hit = np.zeros(len(c), bool)
        hit[inside] = m[yi[inside], xi[inside]]
        votes += hit.astype(np.int32)
    keep = votes >= min_views
    if invert:
        keep = ~keep
    return compact(vertices, faces[keep])
