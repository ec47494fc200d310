"""The port's mesh post-processing (`mesh/clean.py`, `denoise.py`,
`render.py`, `lscm.py`, `uv_atlas.py`) and the multi-band blend
(`panorama/compositing.py`) against the JAX package's, on the CPU.

Host numpy code (manifold repair, LSCM, charts, the geometry raster,
masking) must give equal outputs. Tensor code is held to float32 rounding:
`denoise_sd` and `resample` (scatter sums in another order) at atol 1e-5,
the Laplacian blend at atol 1e-5, the z-buffer's depths at rtol 1e-5 with
face ids equal outside at most 0.5 % of the hit pixels (an edge function
one ulp apart flips a pixel on an edge two faces share; the depths agree
there), and the textured atlas within 1/255 of JAX's at 256 x 256.
"""

import os

import numpy as np
import pytest
import torch
from scipy.spatial import ConvexHull

import jax.numpy as jnp
from alicevision_tpu.mesh import clean as jclean
from alicevision_tpu.mesh import denoise as jden
from alicevision_tpu.mesh import lscm as jlscm
from alicevision_tpu.mesh import render as jrender
from alicevision_tpu.mesh import uv_atlas as juv
from alicevision_tpu.panorama import compositing as jcomp
from alicevision_tpu_torch.image.io import read_image
from alicevision_tpu_torch.mesh import clean as tclean
from alicevision_tpu_torch.mesh import denoise as tden
from alicevision_tpu_torch.mesh import lscm as tlscm
from alicevision_tpu_torch.mesh import render as trender
from alicevision_tpu_torch.mesh import uv_atlas as tuv
from alicevision_tpu_torch.panorama import compositing as tcomp

torch.set_num_threads(1)

MAX_TIE_FRAC = 0.005  # face ids that may differ, of the hit pixels


def _sphere(n=300, seed=0, noise=0.0):
    """A convex-hull sphere with outward faces, optionally with noisy
    vertices."""
    rng = np.random.RandomState(seed)
    P = rng.randn(n, 3)
    P /= np.linalg.norm(P, axis=1, keepdims=True)
    F = ConvexHull(P).simplices.astype(np.int64)
    n_f = np.cross(P[F[:, 1]] - P[F[:, 0]], P[F[:, 2]] - P[F[:, 0]])
    flip = np.sum(n_f * P[F].mean(1), axis=1) < 0
    F[flip] = F[flip][:, ::-1]
    return (P + noise * rng.randn(*P.shape)).astype(np.float32), F


# The meshes of tests/test_mesh_clean.py
_QUAD_V = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
_QUAD_F = np.array([[0, 1, 2], [0, 1, 2], [2, 1, 0], [1, 1, 2], [1, 3, 2]], np.int64)
_FIN_V = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [2, 0, 0], [1, 0.5, 1]], np.float32)
_FIN_F = np.array([[0, 1, 2], [0, 2, 3], [1, 4, 2], [1, 5, 2]], np.int64)
_BOW_V = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0]], np.float32)
_BOW_F = np.array([[0, 1, 2], [0, 3, 4]], np.int64)
_OCT_V = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32)
_OCT_F = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]],
                  np.int64)[1:]
_E2E_V = np.concatenate([_FIN_V, [[9, 9, 9]]]).astype(np.float32)
_E2E_F = np.array([[0, 1, 2], [0, 2, 3], [1, 4, 2], [1, 5, 2], [0, 1, 2], [1, 1, 2]], np.int64)


def _holed_sphere():
    """The sphere with two faces cut out, a duplicate face and a fin."""
    v, f = _sphere(200, seed=3)
    f = np.concatenate([f[2:], f[5:6], [[f[10, 0], f[10, 1], f[40, 2]]]])
    return v, f


@pytest.mark.parametrize("name,v,f", [
    ("duplicates", _QUAD_V, _QUAD_F), ("fin", _FIN_V, _FIN_F), ("bowtie", _BOW_V, _BOW_F),
    ("open_octahedron", _OCT_V, _OCT_F), ("end_to_end", _E2E_V, _E2E_F),
    ("holed_sphere", *_holed_sphere()),
])
def test_clean_pieces_match(name, v, f):
    for fn in ("remove_degenerate_faces", "remove_nonmanifold_edges"):
        args = (v, f) if fn == "remove_degenerate_faces" else (f, v)
        np.testing.assert_array_equal(getattr(tclean, fn)(*args), getattr(jclean, fn)(*args))
    np.testing.assert_array_equal(tclean.remove_duplicate_faces(f), jclean.remove_duplicate_faces(f))
    for a, b in zip(tclean.split_nonmanifold_vertices(v, f), jclean.split_nonmanifold_vertices(v, f)):
        np.testing.assert_array_equal(a, b)
    ta, ja = tclean.boundary_loops(f), jclean.boundary_loops(f)
    assert len(ta) == len(ja) and all(np.array_equal(x, y) for x, y in zip(ta, ja))
    np.testing.assert_array_equal(tclean.fill_small_holes(v, f, max_edges=8),
                                  jclean.fill_small_holes(v, f, max_edges=8))
    for kw in ({}, {"fill_holes_max_edges": 8}):
        for a, b in zip(tclean.clean_mesh(v, f, **kw), jclean.clean_mesh(v, f, **kw)):
            np.testing.assert_array_equal(a, b)


def test_denoise_sd_matches():
    v, f = _sphere(300, seed=1, noise=0.02)
    ref = jden.denoise_sd(v, f, iterations=3, sigma_n=0.35)
    got = tden.denoise_sd(v, f, iterations=3, sigma_n=0.35, device="cpu")
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert np.abs(got - v).max() > 1e-3  # it moved the vertices


def test_resample_matches():
    v, f = _sphere(300, seed=2)
    rv, rf = jden.resample(v.astype(np.float64), f, target_edge=0.15)
    tv, tf = tden.resample(v.astype(np.float64), f, target_edge=0.15, device="cpu")
    np.testing.assert_array_equal(tf, rf)
    np.testing.assert_allclose(tv, rv, atol=1e-5)


def test_mask_faces_by_views_matches():
    v, f = _sphere(300, seed=4)
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
    projs, masks = [], []
    for k, c in enumerate(([0, 0, -4.0], [0.5, 0.2, -4.0])):
        c = np.asarray(c)

        def proj(X, c=c):
            Xc = X - c
            uvh = Xc @ K.T
            return uvh[:, :2] / np.maximum(uvh[:, 2:], 1e-9), Xc[:, 2]

        m = np.zeros((48, 64), bool)
        m[10 + 4 * k : 40, 8:50 - 6 * k] = True
        projs.append(proj)
        masks.append(m)
    for mv, inv in ((1, False), (2, False), (1, True)):
        a = tden.mask_faces_by_views(v, f, projs, masks, min_views=mv, invert=inv)
        b = jden.mask_faces_by_views(v, f, projs, masks, min_views=mv, invert=inv)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _render_scene():
    """Two overlapping spheres (occlusion and ties on shared edges) and a
    camera that sees both."""
    v1, f1 = _sphere(400, seed=5)
    v2, f2 = _sphere(200, seed=6)
    v = np.concatenate([v1, 0.6 * v2 + [0.5, 0.3, -0.9]])
    f = np.concatenate([f1, f2 + len(v1)])
    return v, f


_CAMS = {
    "front": (np.array([[90.0, 0, 40], [0, 90.0, 30], [0, 0, 1]]), np.eye(3), np.array([0.1, -0.2, -4.0])),
    "oblique": (np.array([[70.0, 0, 36], [0, 72.0, 27], [0, 0, 1]]),
                np.array([[0.9553, 0, -0.2955], [0, 1, 0], [0.2955, 0, 0.9553]]), np.array([-1.1, 0.3, -3.6])),
}


@pytest.mark.parametrize("cam", sorted(_CAMS))
def test_render_depth_map_matches(cam):
    v, f = _render_scene()
    K, R, c = _CAMS[cam]
    jd, jf = jrender.render_depth_map(v, f, K, R, c, (60, 80))
    td, tf = trender.render_depth_map(v, f, K, R, c, (60, 80), device="cpu")
    assert td.dtype == np.float32 and tf.dtype == np.int32
    np.testing.assert_array_equal(td > 0, jd > 0)
    np.testing.assert_allclose(td, jd, rtol=1e-5)
    hit = jf >= 0
    assert hit.mean() > 0.2
    flipped = (tf != jf) & hit
    assert flipped.sum() <= MAX_TIE_FRAC * hit.sum(), flipped.sum()


def test_render_normal_map_and_visibility_match():
    v, f = _render_scene()
    cams = [(*_CAMS[k], (60, 80)) for k in sorted(_CAMS)]
    for camera_frame in (True, False):
        tn, td = trender.render_normal_map(v, f, *cams[0], camera_frame=camera_frame, device="cpu")
        jn, jd = jrender.render_normal_map(v, f, *cams[0], camera_frame=camera_frame)
        np.testing.assert_allclose(tn, jn, atol=1e-6)
        np.testing.assert_allclose(td, jd, rtol=1e-5)
    np.testing.assert_array_equal(trender.visible_faces(v, f, cams, device="cpu"), jrender.visible_faces(v, f, cams))
    for a, b in zip(trender.remove_unseen_faces(v, f, cams, device="cpu"), jrender.remove_unseen_faces(v, f, cams)):
        np.testing.assert_array_equal(a, b)


def _cap(n=12, curvature=0.35):
    """A curved grid chart (tests/test_lscm.py's cap)."""
    xs, ys = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n))
    z = curvature * (xs**2 + ys**2)
    V = np.stack([xs.ravel(), ys.ravel(), z.ravel()], -1)
    F = []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b, c, d = i * n + j, i * n + j + 1, (i + 1) * n + j, (i + 1) * n + j + 1
            F += [[a, b, d], [a, d, c]]
    return V, np.array(F, np.int64)


def test_lscm_unwrap_matches():
    V, F = _cap()
    uv_t, uv_j = tlscm.lscm_unwrap(V, F), jlscm.lscm_unwrap(V, F)
    np.testing.assert_array_equal(uv_t, uv_j)
    assert tlscm.conformal_error(V, F, uv_t) == jlscm.conformal_error(V, F, uv_j)
    with pytest.raises(ValueError):
        tlscm.lscm_unwrap(V[:2], F[:0])


def _texture_scene():
    """A curved cap seen by three cameras with textured images and one
    depth map for the occlusion test."""
    V, F = _cap(10)
    V, F = V.astype(np.float64), F[:, ::-1].copy()  # faces toward the cameras (-z)
    H = W = 64
    ys, xs = np.mgrid[0:H, 0:W]
    imgs = [(0.5 + 0.3 * np.sin(xs / (4.0 + k)) * np.cos(ys / 5.0) + 0.1 * k).clip(0, 1).astype(np.float32)
            for k in range(3)]
    K = np.tile(np.array([[40.0, 0, 32], [0, 40.0, 32], [0, 0, 1]]), (3, 1, 1))
    R = np.tile(np.eye(3), (3, 1, 1))
    c = np.array([[-0.6, 0.0, -3.0], [0.6, 0.2, -3.0], [0.0, -0.5, -3.2]])
    depth, _ = jrender.render_depth_map(V, F, K[0], R[0], c[0], (H, W))
    return V, F, imgs, K, R, c, [depth, None, None]


def test_face_view_scores_charts_and_geometry_match():
    V, F, imgs, K, R, c, dms = _texture_scene()
    for d in (None, dms):
        np.testing.assert_array_equal(tuv.face_view_scores(V, F, K, R, c, d), juv.face_view_scores(V, F, K, R, c, d))
    scores = juv.face_view_scores(V, F, K, R, c, dms)
    best = juv.assign_best_views(V, F, K, R, c, dms)
    np.testing.assert_array_equal(tuv.assign_best_views(V, F, K, R, c, dms), best)
    tch, jch = tuv.build_charts(F, best), juv.build_charts(F, best)
    assert len(tch) == len(jch) > 1 and all(np.array_equal(a, b) for a, b in zip(tch, jch))
    for method in ("lscm", "orthographic"):
        (tu, tp), (ju, jp) = (m.unwrap_and_pack(V, F, jch, best, 40.0, 256, method=method) for m in (tuv, juv))
        np.testing.assert_array_equal(tu, ju)
        assert tp == jp
    uvs, _ = juv.unwrap_and_pack(V, F, jch, best, 40.0, 256)
    for a, b in zip(tuv.rasterize_geometry(V, F, uvs, 256), juv.rasterize_geometry(V, F, uvs, 256)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tuv.rasterize_atlas(V, F, uvs, best, imgs, K, R, c, 256),
                    juv.rasterize_atlas(V, F, uvs, best, imgs, K, R, c, 256)):
        np.testing.assert_array_equal(a, b)
    seconds = {}
    ta, tfill = tuv.rasterize_atlas_multiband(V, F, uvs, scores, imgs, K, R, c, 256, 3, 4, device="cpu",
                                              seconds=seconds)
    ja, jfill = juv.rasterize_atlas_multiband(V, F, uvs, scores, imgs, K, R, c, 256, 3, 4)
    np.testing.assert_array_equal(tfill, jfill)
    np.testing.assert_allclose(ta, ja, atol=1e-5)
    assert set(seconds) == {"geometry", "layers", "blend"}


@pytest.mark.parametrize("shape,levels", [((3, 64, 64), 4), ((4, 67, 45), 4), ((2, 33, 80), 3)])
def test_laplacian_blend_matches(shape, levels):
    rng = np.random.default_rng(sum(shape))
    imgs = rng.random(shape).astype(np.float32)
    w = rng.random(shape).astype(np.float32)
    w /= w.sum(0)
    ref = np.asarray(jcomp.laplacian_blend(jnp.asarray(imgs), jnp.asarray(w), levels=levels))
    got = tcomp.laplacian_blend(torch.from_numpy(imgs), torch.from_numpy(w), levels=levels).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_generate_textured_mesh_matches(tmp_path):
    V, F, imgs, K, R, c, dms = _texture_scene()
    dense = (V + 0.01 * np.sin(V[:, :1] * 5), F)
    outs = {}
    for name, mod, kw in (("jax", juv, {}), ("port", tuv, {"device": "cpu"})):
        obj = str(tmp_path / f"{name}.obj")
        uvs, atlas, best = mod.generate_textured_mesh(V, F, imgs, K, R, c, obj, depth_maps=dms, atlas_size=256,
                                                      texel_per_unit=40.0, top_k=3, levels=4,
                                                      bake_from_dense=dense, **kw)
        outs[name] = (obj, uvs, atlas, best)
    (jo, ju, ja, jb), (to, tu, ta, tb) = outs["jax"], outs["port"]
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_allclose(ta, ja, atol=1e-5)
    with open(jo) as a, open(to) as b:
        assert a.read().replace("jax", "port") == b.read()
    for suffix in ("_atlas.png", "_normals.png", "_heights.png"):
        pj = read_image(jo.replace(".obj", suffix))
        pt = read_image(to.replace(".obj", suffix))
        assert pt.shape == pj.shape and np.abs(pt - pj).max() <= 1.0 / 255 + 1e-7, suffix
    assert (read_image(to.replace(".obj", "_atlas.png"), grayscale=True) > 0).mean() > 0.05


def test_mesh_entry_points_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    v, f = _sphere(50)
    K, R, c = _CAMS["front"]
    with pytest.raises(RuntimeError, match="CUDA"):
        trender.render_depth_map(v, f, K, R, c, (8, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        tden.denoise_sd(v, f, iterations=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tuv.generate_textured_mesh(v, f, [np.zeros((8, 8), np.float32)] * 2, np.stack([K, K]), np.stack([R, R]),
                                   np.stack([c, c]), os.devnull)
