"""Tiny CPU ray-cast renderer for synthetic test scenes.

A host copy of `alicevision_tpu/utils/render.py` (numpy and scipy, the
same arrays byte for byte).

Renders a two-plane textured scene (ground plane + raised patch) by exact
ray casting — gives pixel-accurate multi-view images with known geometry
for end-to-end pipeline tests and benchmarks. The reference ships no such
renderer; its engine tests stop at synthetic projections (NViewDataSet).
Real images exercise the whole front-end (SIFT, matching) as well.
"""

from __future__ import annotations

import numpy as np


def procedural_texture(seed: int, size: int = 512, octaves: int = 4) -> np.ndarray:
    """Multi-octave value noise in [0, 1] — rich in SIFT-detectable blobs."""
    rng = np.random.RandomState(seed)
    tex = np.zeros((size, size), np.float32)
    import scipy.ndimage as ndi

    for o in range(octaves):
        n = size >> (octaves - 1 - o)
        layer = rng.rand(n, n).astype(np.float32)
        layer = ndi.zoom(layer, size / n, order=1)[:size, :size]
        tex += layer / (2**o)
    tex -= tex.min()
    tex /= tex.max()
    return tex


def look_at(c, target, up=(0, 0, 1)):
    """World->camera rotation for a camera at c looking at target."""
    fwd = np.asarray(target, float) - np.asarray(c, float)
    fwd /= np.linalg.norm(fwd)
    up = np.asarray(up, float)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd])


def render_two_plane_scene(
    R: np.ndarray,
    c: np.ndarray,
    K: np.ndarray,
    wh=(640, 480),
    patch_half: float = 1.0,
    patch_z: float = 1.0,
    tex_scale: float = 0.04,
    seed: int = 0,
):
    """Render the scene {ground plane z=0} U {patch |x|,|y|<=h at z=patch_z}
    from a camera (R, c). Returns (image (H, W), depth (H, W))."""
    W, H = wh
    tex0 = procedural_texture(seed, 512)
    tex1 = procedural_texture(seed + 1, 512)

    ys, xs = np.mgrid[0:H, 0:W]
    d_cam = np.stack(
        [
            (xs - K[0, 2]) / K[0, 0],
            (ys - K[1, 2]) / K[1, 1],
            np.ones_like(xs, float),
        ],
        axis=-1,
    )
    d_world = d_cam @ R  # rows of R are camera axes -> R^T d
    d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)

    def plane_hit(z_plane):
        dz = d_world[..., 2]
        t = (z_plane - c[2]) / np.where(np.abs(dz) < 1e-9, 1e-9, dz)
        P = c[None, None, :] + t[..., None] * d_world
        ok = t > 1e-6
        return t, P, ok

    t0, P0, ok0 = plane_hit(0.0)
    t1, P1, ok1 = plane_hit(patch_z)
    on_patch = (
        ok1
        & (np.abs(P1[..., 0]) <= patch_half)
        & (np.abs(P1[..., 1]) <= patch_half)
    )

    use1 = on_patch & (~ok0 | (t1 < t0))

    def sample(tex, P):
        u = np.mod(P[..., 0] / tex_scale, tex.shape[1] - 1)
        v = np.mod(P[..., 1] / tex_scale, tex.shape[0] - 1)
        u0, v0 = np.floor(u).astype(int), np.floor(v).astype(int)
        # grazing rays produce huge coords whose float mod can hit the bound
        u0 = np.clip(u0, 0, tex.shape[1] - 2)
        v0 = np.clip(v0, 0, tex.shape[0] - 2)
        fu, fv = u - u0, v - v0
        return (
            tex[v0, u0] * (1 - fu) * (1 - fv)
            + tex[v0, u0 + 1] * fu * (1 - fv)
            + tex[v0 + 1, u0] * (1 - fu) * fv
            + tex[v0 + 1, u0 + 1] * fu * fv
        )

    img = np.where(use1, sample(tex1, P1), np.where(ok0, sample(tex0, P0), 0.0))

    # depth along camera z
    z_fac = d_cam[..., 2] / np.linalg.norm(d_cam, axis=-1)
    t_sel = np.where(use1, t1, np.where(ok0, t0, -1.0))
    depth = np.where(t_sel > 0, t_sel * z_fac, -1.0)
    return img.astype(np.float32), depth.astype(np.float32)


def make_test_dataset(
    out_dir: str,
    n_views: int = 5,
    wh=(640, 480),
    focal: float = 500.0,
    height: float = 5.0,
    spread: float = 2.0,
    seed: int = 0,
):
    """Write a ring of rendered views to out_dir as PNGs; returns GT poses."""
    import os

    from ..image.io import write_image

    os.makedirs(out_dir, exist_ok=True)
    W, H = wh
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]])
    Rs, cs = [], []
    rng = np.random.RandomState(seed)
    for i in range(n_views):
        a = 2 * np.pi * i / n_views
        c = np.array(
            [spread * np.cos(a), spread * np.sin(a), height + rng.uniform(-0.3, 0.3)]
        )
        R = look_at(c, (0, 0, 0), up=(0, 1, 0))
        img, depth = render_two_plane_scene(R, c, K, wh, seed=seed)
        write_image(os.path.join(out_dir, f"view_{i:03d}.png"), img)
        Rs.append(R)
        cs.append(c)
    return K, np.stack(Rs), np.stack(cs)
