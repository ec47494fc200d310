"""UV atlas generation + texture baking.

Port of `alicevision_tpu/mesh/uv_atlas.py`, the counterpart of the
reference's full texturing stage
(ref: src/aliceVision/mesh/Texturing.hpp:75,153 unwrap() — LSCM via
Geogram or UVAtlas packing — and generateTextures' per-triangle best-view
scoring with multi-band fusion [Waechter2014]).

Design: charts are connected groups of triangles with similar best-view
assignment; each chart is unwrapped by orthographic projection along its
mean normal (the LSCM solution for near-planar charts), packed into the
atlas with a shelf packer, and the texels are filled by projecting into
the chart's view with depth-occlusion tests. Everything is host numpy, as
in the reference, except the multi-band fusion's Laplacian blend, which
runs on `device`. `generate_textured_mesh` takes a `seconds` dict for its
wall seconds by step.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from .ops import vertex_normals


def _face_normals(V, F):
    p0, p1, p2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    n = np.cross(p1 - p0, p2 - p0)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def face_view_scores(
    V, F, K, R, c, depth_maps=None, depth_tol=0.05
) -> np.ndarray:
    """(n_views, F) per-face view quality — cos(angle)/d^2 with optional
    depth-occlusion gating, -inf where a face is invisible
    ([Waechter2014]-style scoring, ref: mesh/Texturing.cpp best-view
    selection in generateTextures)."""
    fn = _face_normals(V, F)
    centers = V[F].mean(axis=1)  # (F, 3)
    n_views = len(K)
    scores = np.full((n_views, len(F)), -np.inf)
    for v in range(n_views):
        x_cam = (R[v] @ (centers - c[v]).T).T
        z = x_cam[:, 2]
        ok = z > 1e-6
        view_dir = c[v] - centers
        dist = np.linalg.norm(view_dir, axis=-1)
        view_dir /= np.maximum(dist[:, None], 1e-12)
        cosang = np.sum(view_dir * fn, axis=-1)
        score = np.where(ok & (cosang > 0.05), cosang / np.maximum(dist, 1e-6) ** 2, -np.inf)
        if depth_maps is not None and depth_maps[v] is not None:
            H, W = depth_maps[v].shape
            u = K[v][0, 0] * x_cam[:, 0] / np.where(ok, z, 1) + K[v][0, 2]
            w_ = K[v][1, 1] * x_cam[:, 1] / np.where(ok, z, 1) + K[v][1, 2]
            ui = np.clip(u.astype(int), 0, W - 1)
            wi = np.clip(w_.astype(int), 0, H - 1)
            d = depth_maps[v][wi, ui]
            vis = (d > 0) & (np.abs(d - z) < depth_tol * np.maximum(z, 1e-6))
            score = np.where(vis, score, -np.inf)
        scores[v] = score
    return scores


def assign_best_views(
    V, F, K, R, c, depth_maps=None, depth_tol=0.05
) -> np.ndarray:
    """Best view per face by the cos/d^2 score with optional occlusion."""
    scores = face_view_scores(V, F, K, R, c, depth_maps, depth_tol)
    best = np.argmax(scores, axis=0).astype(np.int64)
    best[~np.isfinite(scores.max(axis=0))] = -1
    return best


def build_charts(F, best_view) -> list:
    """Connected face groups sharing a best view (chart segmentation)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    nF = len(F)
    # face adjacency via shared edges
    edges = {}
    rows, cols = [], []
    for fi, tri in enumerate(F):
        for a, b in ((0, 1), (1, 2), (2, 0)):
            key = (min(tri[a], tri[b]), max(tri[a], tri[b]))
            if key in edges:
                fj = edges[key]
                if best_view[fi] == best_view[fj]:
                    rows.append(fi)
                    cols.append(fj)
            else:
                edges[key] = fi
    g = coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(nF, nF))
    n_comp, label = connected_components(g, directed=False)
    charts = []
    for comp in range(n_comp):
        faces = np.nonzero(label == comp)[0]
        if len(faces):
            charts.append(faces)
    return charts


def unwrap_and_pack(
    V, F, charts, best_view, texel_per_unit: float = 64.0, atlas_size: int = 1024,
    margin: int = 2, method: str = "lscm",
):
    """Per-chart unwrap + shelf packing.

    method "lscm" (default) computes a least-squares conformal
    parameterization per chart (the reference's Geogram LSCM path,
    mesh/Texturing.cpp:61-74) with orthographic projection as the fallback
    for degenerate charts; "orthographic" forces the projection unwrap.

    Returns (uvs (F, 3, 2) in [0,1], chart placements)."""
    uvs = np.zeros((len(F), 3, 2))
    placements = []
    boxes = []
    chart_uv_local = []
    for faces in charts:
        verts_idx = F[faces].reshape(-1)
        pts = V[verts_idx]
        uv = None
        if method == "lscm":
            from .lscm import lscm_unwrap

            # chart-local vertex table (LSCM needs shared vertices)
            uniq, inv = np.unique(verts_idx, return_inverse=True)
            try:
                uv_v = lscm_unwrap(V[uniq], inv.reshape(-1, 3))
                uv = uv_v[inv] * texel_per_unit
            except ValueError:
                uv = None
        if uv is None:
            # orthographic basis from the mean normal
            n = _face_normals(V, F[faces]).mean(0)
            n /= max(np.linalg.norm(n), 1e-12)
            a = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
            e1 = np.cross(n, a)
            e1 /= max(np.linalg.norm(e1), 1e-12)
            e2 = np.cross(n, e1)
            uv = np.stack([pts @ e1, pts @ e2], -1) * texel_per_unit
        uv -= uv.min(0)
        chart_uv_local.append(uv.reshape(len(faces), 3, 2))
        boxes.append(uv.max(0) + 2 * margin)

    # shelf packing by decreasing height
    order = np.argsort([-b[1] for b in boxes])
    x = y = shelf_h = 0
    scale_retry = 1.0
    pos = [None] * len(charts)
    for ci in order:
        w, h = boxes[ci]
        if x + w > atlas_size:
            x = 0
            y += shelf_h
            shelf_h = 0
        if y + h > atlas_size:
            # overflow: clamp into the last shelf (best-effort)
            y = max(0, atlas_size - h)
        pos[ci] = (x + margin, y + margin)
        x += w
        shelf_h = max(shelf_h, h)

    for ci, faces in enumerate(charts):
        px, py = pos[ci]
        uv = chart_uv_local[ci] + np.array([px, py])
        uvs[faces] = uv / atlas_size
    return uvs, pos


def rasterize_geometry(V, F, uvs, atlas_size: int = 1024):
    """One geometry pass over the atlas: per-texel 3D position + face id.

    Every downstream consumer (color sampling per view layer, normal/height
    baking) reads these maps instead of re-rasterizing — the analog of the
    reference's per-triangle texel accumulation in
    Texturing::generateTexturesSubSet."""
    pos = np.zeros((atlas_size, atlas_size, 3), np.float64)
    fid = np.full((atlas_size, atlas_size), -1, np.int64)
    for fi, tri in enumerate(F):
        uv = uvs[fi] * atlas_size  # (3, 2)
        x0, y0 = np.floor(uv.min(0)).astype(int)
        x1, y1 = np.ceil(uv.max(0)).astype(int) + 1
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, atlas_size), min(y1, atlas_size)
        if x1 <= x0 or y1 <= y0:
            continue
        ys, xs = np.mgrid[y0:y1, x0:x1]
        p = np.stack([xs + 0.5, ys + 0.5], -1)
        a, b, cc = uv[0], uv[1], uv[2]
        den = (b[1] - cc[1]) * (a[0] - cc[0]) + (cc[0] - b[0]) * (a[1] - cc[1])
        if abs(den) < 1e-12:
            continue
        l1 = ((b[1] - cc[1]) * (p[..., 0] - cc[0]) + (cc[0] - b[0]) * (p[..., 1] - cc[1])) / den
        l2 = ((cc[1] - a[1]) * (p[..., 0] - cc[0]) + (a[0] - cc[0]) * (p[..., 1] - cc[1])) / den
        l3 = 1 - l1 - l2
        inside = (l1 >= -0.02) & (l2 >= -0.02) & (l3 >= -0.02)
        if not inside.any():
            continue
        P3 = (
            l1[..., None] * V[tri[0]]
            + l2[..., None] * V[tri[1]]
            + l3[..., None] * V[tri[2]]
        )
        m = inside & (fid[y0:y1, x0:x1] < 0)
        pos[y0:y1, x0:x1][m] = P3[m]
        fid[y0:y1, x0:x1][m] = fi
    return pos, fid


def _bilinear(img, u, v):
    """Host-side bilinear fetch of img (H, W[, C]) at float pixel (u, v)."""
    H, W = img.shape[:2]
    u = np.clip(u, 0.0, W - 1.001)
    v = np.clip(v, 0.0, H - 1.001)
    x0 = np.floor(u).astype(int)
    y0 = np.floor(v).astype(int)
    fx, fy = u - x0, v - y0
    if img.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return (i00 * (1 - fx) * (1 - fy) + i01 * fx * (1 - fy)
            + i10 * (1 - fx) * fy + i11 * fx * fy)


def _sample_view(pos, texel_mask, img, Kv, Rv, cv):
    """Project masked texel positions into one view, bilinear color fetch.
    Returns (colors (N, 3), in_view (N,))."""
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    H, W = img.shape[:2]
    P = pos[texel_mask]
    x_cam = (Rv @ (P - cv).T).T
    z = x_cam[:, 2]
    ok = z > 1e-6
    zs = np.where(ok, z, 1.0)
    u = Kv[0, 0] * x_cam[:, 0] / zs + Kv[0, 2]
    w_ = Kv[1, 1] * x_cam[:, 1] / zs + Kv[1, 2]
    ok &= (u >= 0) & (u <= W - 1) & (w_ >= 0) & (w_ <= H - 1)
    col = _bilinear(img, u, w_)[..., :3]
    return col, ok


def rasterize_atlas(
    V, F, uvs, best_view, images, K, R, c, atlas_size: int = 1024,
):
    """Single-band atlas: each texel sampled from its face's best view."""
    pos, fid = rasterize_geometry(V, F, uvs, atlas_size)
    atlas = np.zeros((atlas_size, atlas_size, 3), np.float32)
    filled = fid >= 0
    texel_view = np.where(filled, np.asarray(best_view)[np.where(filled, fid, 0)], -1)
    for v in range(len(images)):
        m = texel_view == v
        if not m.any():
            continue
        col, ok = _sample_view(pos, m, images[v], K[v], R[v], c[v])
        idx = np.nonzero(m)
        atlas[idx[0][ok], idx[1][ok]] = col[ok]
    return atlas, filled


def rasterize_atlas_multiband(
    V, F, uvs, scores, images, K, R, c,
    atlas_size: int = 1024, top_k: int = 4, levels: int = 4, device="cuda",
    seconds: dict | None = None,
):
    """Multi-band fused atlas (the reference's [Waechter2014]-style fusion,
    Texturing::generateTextures multi-band blending).

    scores: (n_views, F) per-face view quality (cos/d^2, -inf invisible).
    The top_k best views per face are rasterized as weighted color layers;
    the layers are fused with Laplacian-pyramid multi-band blending so low
    frequencies blend widely across views while high frequencies keep the
    best view's detail — removing chart seams that a hard best-view
    assignment leaves. The blend runs on `device`, a channel at a time;
    `seconds`, when given, gets the wall seconds of the geometry pass, the
    layers' view sampling (both host) and the blend."""
    from ..panorama.compositing import laplacian_blend

    dev = resolve_device(device)
    seconds = {} if seconds is None else seconds
    t0 = time.perf_counter()

    n_views = len(images)
    top_k = min(top_k, n_views)
    pos, fid = rasterize_geometry(V, F, uvs, atlas_size)
    seconds["geometry"] = time.perf_counter() - t0
    filled = fid >= 0
    order = np.argsort(-scores, axis=0)  # (n_views, F) view ids by rank
    fid_safe = np.where(filled, fid, 0)

    layers = np.zeros((top_k, atlas_size, atlas_size, 3), np.float32)
    weights = np.zeros((top_k, atlas_size, atlas_size), np.float32)
    for k in range(top_k):
        view_of_face = order[k]  # (F,)
        score_of_face = np.take_along_axis(
            scores, view_of_face[None], axis=0
        )[0]
        texel_view = np.where(filled, view_of_face[fid_safe], -1)
        texel_score = np.where(filled, score_of_face[fid_safe], 0.0)
        for v in range(n_views):
            m = texel_view == v
            if not m.any():
                continue
            col, ok = _sample_view(pos, m, images[v], K[v], R[v], c[v])
            idx = np.nonzero(m)
            yy, xx = idx[0][ok], idx[1][ok]
            layers[k, yy, xx] = col[ok]
            w = np.maximum(texel_score[m][ok], 0.0)
            weights[k, yy, xx] = np.where(np.isfinite(w), w, 0.0)

    seconds["layers"] = time.perf_counter() - t0 - seconds["geometry"]
    t1 = time.perf_counter()
    wsum = weights.sum(0)
    has_w = wsum > 0
    wn = np.where(has_w[None], weights / np.maximum(wsum[None], 1e-12), 0.0)
    # give all-zero texels to layer 0 so the blend stays defined
    wn[0] = np.where(has_w, wn[0], 1.0)

    out = np.zeros((atlas_size, atlas_size, 3), np.float32)
    wn_t = torch.from_numpy(wn).to(dev)
    for ch in range(3):
        layer = torch.from_numpy(np.ascontiguousarray(layers[..., ch])).to(dev)
        out[..., ch] = laplacian_blend(layer, wn_t, levels=levels).cpu().numpy()
    seconds["blend"] = time.perf_counter() - t1
    out = np.where(filled[..., None], out, 0.0)
    return out, filled


def bake_normal_height_maps(
    V, F, uvs, dense_V, dense_F, atlas_size: int = 1024,
):
    """Bake object-space normal + signed height maps from a dense mesh onto
    the (decimated) target mesh's UV atlas
    (ref: mesh/Texturing.cpp _generateNormalAndHeightMaps — Geogram AABB
    closest-point queries; here a cKDTree nearest-vertex query).

    Returns (normal_map (S, S, 3) in [-1, 1], height_map (S, S), filled)."""
    from scipy.spatial import cKDTree

    pos, fid = rasterize_geometry(V, F, uvs, atlas_size)
    filled = fid >= 0
    dense_n = vertex_normals(dense_V, dense_F)
    tree = cKDTree(dense_V)
    P = pos[filled]
    _, nearest = tree.query(P, k=1)
    n_dense = dense_n[nearest]

    # target-surface normal per texel (face normal of the coarse mesh)
    fnorm = _face_normals(V, F)
    n_target = fnorm[np.where(filled, fid, 0)][filled]
    # signed height along the coarse normal to the dense surface point
    h = np.sum((dense_V[nearest] - P) * n_target, axis=-1)

    normal_map = np.zeros((atlas_size, atlas_size, 3), np.float32)
    height_map = np.zeros((atlas_size, atlas_size), np.float32)
    normal_map[filled] = n_dense
    height_map[filled] = h
    return normal_map, height_map, filled


def generate_textured_mesh(
    V, F, images, K, R, c, out_obj: str, depth_maps=None,
    atlas_size: int = 1024, texel_per_unit: float = 64.0,
    multiband: bool = True, top_k: int = 4, levels: int = 4,
    bake_from_dense=None,  # optional (dense_V, dense_F) for normal/height maps
    device="cuda", seconds: dict | None = None,
):
    """Full texturing: best views -> charts -> unwrap/pack -> bake -> OBJ
    with MTL + PNG atlas (Texturing::generateTextures equivalent).

    multiband=True fuses the top_k views per face with Laplacian multi-band
    blending (the reference default, Texturing.hpp multiBandNbContrib);
    bake_from_dense bakes object-space normal + height maps from a dense
    mesh onto the atlas (Texturing normal/height map baking). `seconds`,
    when given, gets the wall seconds by step: scores, charts, unwrap, atlas
    (the rasterization and view sampling on the host, and the multi-band
    blend on `device`), bake, write."""
    import os

    from ..image.io import write_image

    dev = resolve_device(device)
    seconds = {} if seconds is None else seconds
    t0 = [time.perf_counter()]

    def lap(step):
        now = time.perf_counter()
        seconds[step] = seconds.get(step, 0.0) + now - t0[0]
        t0[0] = now

    scores = face_view_scores(V, F, K, R, c, depth_maps)
    best = np.argmax(scores, axis=0).astype(np.int64)
    best[~np.isfinite(scores.max(axis=0))] = -1
    lap("scores")
    charts = build_charts(F, best)
    lap("charts")
    uvs, _ = unwrap_and_pack(V, F, charts, best, texel_per_unit, atlas_size)
    lap("unwrap")
    if multiband and len(images) > 1:
        atlas, filled = rasterize_atlas_multiband(
            V, F, uvs, scores, images, K, R, c, atlas_size, top_k, levels, device=dev,
            seconds=seconds,
        )
        t0[0] = time.perf_counter()
    else:
        atlas, filled = rasterize_atlas(V, F, uvs, best, images, K, R, c, atlas_size)
        lap("atlas")

    if bake_from_dense is not None:
        dense_V, dense_F = bake_from_dense
        nmap, hmap, _ = bake_normal_height_maps(
            V, F, uvs, dense_V, dense_F, atlas_size
        )
        base0 = os.path.splitext(out_obj)[0]
        write_image(base0 + "_normals.png", 0.5 * (nmap + 1.0))
        hn = hmap - hmap.min()
        hn /= max(hn.max(), 1e-12)
        write_image(base0 + "_heights.png", hn)
        lap("bake")

    base = os.path.splitext(out_obj)[0]
    png = base + "_atlas.png"
    mtl = base + ".mtl"
    write_image(png, atlas)
    with open(mtl, "w") as f:
        f.write(f"newmtl textured\nKd 1 1 1\nmap_Kd {os.path.basename(png)}\n")
    with open(out_obj, "w") as f:
        f.write(f"mtllib {os.path.basename(mtl)}\nusemtl textured\n")
        for v in V:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for fi in range(len(F)):
            for k in range(3):
                u, vv = uvs[fi, k]
                f.write(f"vt {u} {1.0 - vv}\n")
        for fi, tri in enumerate(F):
            t = 3 * fi
            f.write(
                f"f {tri[0]+1}/{t+1} {tri[1]+1}/{t+2} {tri[2]+1}/{t+3}\n"
            )
    lap("write")
    return uvs, atlas, best
