"""Mesh rasterization: depth maps, normal maps, visibility.

Port of `alicevision_tpu/mesh/render.py` (ref:
src/software/pipeline/main_depthMapRendering.cpp,
main_normalMapRendering.cpp, main_meshRemoveUnseenFaces.cpp). The z-buffer
is a reduction over fixed chunks of 32 faces, as the reference's scan: for
each chunk an (32, H*W) edge-function test and perspective-correct 1/z
interpolation give candidate depths, and a running minimum across chunks
keeps the nearest. Within a chunk the first face of equal depth wins
(`argmin`); across chunks a face replaces the buffer only where it is
strictly nearer, so the face ids are the reference's. The loop over chunks
runs on `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

_CHUNK = 32  # faces a step, as the reference's scan


def _project(V, K, R, c):
    """World verts (N,3) -> pixel (N,2), camera depth (N,)."""
    Xc = (V - c) @ R.T
    z = Xc[:, 2]
    uv = (Xc @ K.T)[:, :2] / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)[:, None]
    return uv, z


def _edge(a, b, p):
    """Signed area of (a, b, p) for (F, 2) a, b and (P, 2) p: (F, P)."""
    return (b[:, None, 0] - a[:, None, 0]) * (p[None, :, 1] - a[:, None, 1]) - (
        b[:, None, 1] - a[:, None, 1]
    ) * (p[None, :, 0] - a[:, None, 0])


def _chunk_depth(Vp, z, fc, px):
    """Candidate depths (32, P) of one chunk of faces, inf where a pixel
    lies outside a face, a face is degenerate or behind the camera, or the
    row is padding (-1)."""
    valid_f = fc[:, 0] >= 0
    idx = fc.clamp_min(0)
    a, b, cc = Vp[idx[:, 0]], Vp[idx[:, 1]], Vp[idx[:, 2]]
    za, zb, zc = z[idx[:, 0]], z[idx[:, 1]], z[idx[:, 2]]
    w0 = _edge(b, cc, px)
    w1 = _edge(cc, a, px)
    w2 = _edge(a, b, px)
    area = w0 + w1 + w2
    # inside if all barycentrics share the sign of the area
    s = torch.sign(area)
    inside = (w0 * s >= 0) & (w1 * s >= 0) & (w2 * s >= 0) & (area.abs() > 1e-12)
    inv_area = 1.0 / torch.where(area.abs() < 1e-12, torch.full_like(area, 1e-12), area)
    b0, b1, b2 = w0 * inv_area, w1 * inv_area, w2 * inv_area
    # 1/z is affine in screen space -> perspective-correct depth
    inv_z = (
        b0 * (1.0 / za.clamp_min(1e-9))[:, None]
        + b1 * (1.0 / zb.clamp_min(1e-9))[:, None]
        + b2 * (1.0 / zc.clamp_min(1e-9))[:, None]
    )
    depth = 1.0 / inv_z.clamp_min(1e-12)
    front = (za > 1e-6) & (zb > 1e-6) & (zc > 1e-6)
    ok = inside & (front & valid_f)[:, None]
    return torch.where(ok, depth, torch.full_like(depth, float("inf")))


def _raster_depth(Vp, z, F, hw):
    """Z-buffer raster. Vp (N,2) pixel verts, z (N,) depths, F (M,3) faces.
    Returns (depth (H,W), face_id (H,W) int32), 0 and -1 where no face."""
    H, W = hw
    dev = Vp.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev), indexing="ij")
    px = torch.stack([xs + 0.5, ys + 0.5], -1).reshape(-1, 2).to(torch.float32)
    pad = (-F.shape[0]) % _CHUNK
    Fp = torch.cat([F, torch.full((pad, 3), -1, dtype=F.dtype, device=dev)])
    zbuf = torch.full((H * W,), float("inf"), device=dev)
    fbuf = torch.full((H * W,), -1, dtype=torch.int32, device=dev)
    for ci in range(Fp.shape[0] // _CHUNK):
        depth = _chunk_depth(Vp, z, Fp[ci * _CHUNK : (ci + 1) * _CHUNK], px)
        dmin, best = depth.amin(0), depth.argmin(0)  # argmin: the first of equal depths
        upd = dmin < zbuf
        fbuf = torch.where(upd, (ci * _CHUNK + best).to(torch.int32), fbuf)
        zbuf = torch.minimum(zbuf, dmin)
    hit = torch.isfinite(zbuf)
    depth = torch.where(hit, zbuf, torch.zeros_like(zbuf)).reshape(H, W)
    face_id = torch.where(hit, fbuf, torch.full_like(fbuf, -1)).reshape(H, W)
    return depth, face_id


def render_depth_map(V, F, K, R, c, hw, device="cuda"):
    """Render the depth map of mesh (V, F) into camera (K, R world->cam, c).
    Returns (depth (H,W) float32 with 0 = no hit, face_id (H,W) int32)."""
    dev = resolve_device(device)

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    uv, z = _project(t(V), t(K), t(R), t(c))
    depth, fid = _raster_depth(uv, z, t(F, torch.int64), tuple(int(x) for x in hw))
    return depth.cpu().numpy(), fid.cpu().numpy()


def face_normals(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    n = np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]])
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def render_normal_map(V, F, K, R, c, hw, camera_frame: bool = True, device="cuda"):
    """Render per-face normals into the camera. Returns (H,W,3) float32
    (zeros where no face) and the depth (ref: main_normalMapRendering.cpp)."""
    depth, fid = render_depth_map(V, F, K, R, c, hw, device=device)
    n = face_normals(np.asarray(V, np.float64), np.asarray(F))
    if camera_frame:
        n = n @ np.asarray(R).T
        # orient towards the camera (-z in camera frame)
        flip = n[:, 2] > 0
        n[flip] *= -1.0
    out = np.zeros((*depth.shape, 3), np.float32)
    hit = fid >= 0
    out[hit] = n[fid[hit]]
    return out, depth


def visible_faces(V, F, cams, hw_list=None, device="cuda") -> np.ndarray:
    """Count, per face, in how many cameras it is the front-most surface.
    cams: list of (K, R, c) or (K, R, c, (H, W)). Returns (F,) int counts
    (ref: main_meshRemoveUnseenFaces.cpp visibility accumulation)."""
    counts = np.zeros(len(F), np.int64)
    for k, camt in enumerate(cams):
        if len(camt) == 4:
            K, R, c, hw = camt
        else:
            K, R, c = camt
            hw = hw_list[k] if hw_list else (480, 640)
        _, fid = render_depth_map(V, F, K, R, c, hw, device=device)
        counts[np.unique(fid[fid >= 0])] += 1
    return counts


def remove_unseen_faces(V, F, cams, min_views: int = 1, device="cuda"):
    """Drop faces seen by fewer than min_views cameras; compacts vertices."""
    from .ops import compact

    keep = visible_faces(V, F, cams, device=device) >= min_views
    return compact(V, F[keep])
