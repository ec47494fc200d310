"""The port's surface mesher against the JAX reference on the CPU: the C++
max-flow (`native`), `mesh/ops.py`, `mesh/delaunay_graphcut.py`,
`mesh/texturing.py` and the stage `meshing_surface`.

Tolerances: the max-flow's cut value and the source side of every node are
exact on integer capacities (the nodes reachable from the source in the
residual graph are the same for every maximum flow); the graph cut, the
largest component and the colour bake are host numpy in both packages and
must agree exactly; the Taubin smooth (float32 scatter-adds, summed in
another order) within 1e-5; the OBJ files byte for byte. The stage runs on
rendered ground-truth depth maps of 4 views at 160x120 (downscale 2), from
one fused cloud (see `test_meshing_surface_matches`).
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from alicevision_tpu import mesh as jmesh
from alicevision_tpu import native as jnative
from alicevision_tpu.pipeline import stages as jstages
from alicevision_tpu_torch import mesh as tmesh
from alicevision_tpu_torch import native
from alicevision_tpu_torch.pipeline import stages as tstages

torch.set_num_threads(1)


def _sphere_cloud_with_vis(n=800, n_cams=6, radius=1.0, cam_r=4.0, seed=0):
    """tests/test_mesh.py's sphere: n points on the unit sphere, 12 cameras,
    each seeing its front hemisphere."""
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = d * radius
    cams = []
    for i in range(n_cams):
        a = 2 * np.pi * i / n_cams
        for el in (-0.5, 0.5):
            cams.append([cam_r * np.cos(a), cam_r * np.sin(a), el * cam_r])
    cams = np.array(cams)
    vp, vc = [], []
    for cc in cams:
        idx = np.nonzero((pts @ cc) > 0)[0]
        vp.append(idx)
        vc.append(np.tile(cc, (len(idx), 1)))
    return pts, np.concatenate(vp), np.concatenate(vc)


def _random_graph(seed, n=300, n_edges=1200):
    """A random graph with small integer capacities and integer terminal
    capacities on 30 % of the nodes: its min cut splits the nodes."""
    rng = np.random.RandomState(seed)
    eu = rng.randint(0, n, n_edges)
    ev = rng.randint(0, n, n_edges)
    keep = eu != ev
    eu, ev = eu[keep], ev[keep]
    cap = rng.randint(0, 4, len(eu)).astype(np.float64)
    rev = rng.randint(0, 4, len(eu)).astype(np.float64)
    terminal = rng.randint(-30, 31, n).astype(np.float64) * (rng.rand(n) < 0.3)
    return n, eu, ev, cap, rev, terminal


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_maxflow_matches_scipy_and_reference(seed):
    g = _random_graph(seed)
    flow, side = native.maxflow(*g)
    flow_p, side_p = native.maxflow_plain(*g)
    assert flow == flow_p
    np.testing.assert_array_equal(side, side_p)
    flow_j, side_j = jnative.maxflow(*g)
    assert flow == flow_j
    np.testing.assert_array_equal(side, side_j)
    assert 0 < side.sum() < len(side)  # a real cut, not a trivial one


def test_maxflow_library_is_built_from_the_port():
    lib = native.build()
    assert lib.parent == native.BUILD and lib.exists()
    assert lib.name.startswith("libmaxflow-")


@pytest.fixture(scope="module")
def sphere():
    pts, vp, vc = _sphere_cloud_with_vis()
    return pts, vp, vc


def _sorted_faces(f):
    """Faces as a canonical set: each face's indices sorted, then the rows."""
    f = np.sort(f, axis=1)
    return f[np.lexsort(f.T[::-1])]


def test_graph_cut_and_largest_component_match(sphere):
    pts, vp, vc = sphere
    v_j, f_j = jmesh.graph_cut_surface(pts, vp, vc)
    seconds = {}
    v_t, f_t = tmesh.graph_cut_surface(pts, vp, vc, seconds=seconds)
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_array_equal(_sorted_faces(f_t), _sorted_faces(f_j))
    assert set(seconds) == {"delaunay", "votes", "cut", "facets"}
    assert len(f_t) > 500
    lv_j, lf_j = jmesh.largest_component(v_j, f_j)
    lv_t, lf_t = tmesh.largest_component(v_t, f_t)
    np.testing.assert_array_equal(lv_t, lv_j)
    np.testing.assert_array_equal(_sorted_faces(lf_t), _sorted_faces(lf_j))


def test_laplacian_smooth_matches(sphere):
    pts, vp, vc = sphere
    verts, faces = jmesh.graph_cut_surface(pts, vp, vc)
    noisy = verts + 0.03 * np.random.RandomState(2).randn(*verts.shape)
    # one vertex no face references keeps its position in both
    noisy = np.concatenate([noisy, [[5.0, 5.0, 5.0]]])
    ref = jmesh.laplacian_smooth(noisy, faces, iterations=10)
    out = tmesh.laplacian_smooth(torch.as_tensor(noisy, dtype=torch.float32), faces, iterations=10)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(out.numpy()[-1], [5.0, 5.0, 5.0])
    plain = tmesh.laplacian_smooth(torch.as_tensor(noisy, dtype=torch.float32), faces, iterations=3, mu=0.0)
    np.testing.assert_allclose(plain.numpy(), jmesh.laplacian_smooth(noisy, faces, iterations=3, mu=0.0),
                               atol=1e-5, rtol=0)


def test_obj_and_ply_files_match(sphere, tmp_path):
    pts, vp, vc = sphere
    verts, faces = jmesh.graph_cut_surface(pts, vp, vc)
    v32 = verts.astype(np.float32)
    colors = (np.random.RandomState(3).rand(len(verts), 3) * 255).astype(np.uint8)
    for name, kw in (("plain", {}), ("colored", {"colors": colors})):
        for writer in ("save_obj", "save_ply_mesh"):
            ext = "obj" if writer == "save_obj" else "ply"
            a, b = tmp_path / f"t_{name}.{ext}", tmp_path / f"j_{name}.{ext}"
            getattr(tmesh, writer)(str(a), v32, faces, **kw)
            getattr(jmesh.ops, writer)(str(b), v32, faces, **kw)
            assert a.read_bytes() == b.read_bytes(), (name, writer)
    lv, lf = tmesh.load_obj(str(tmp_path / "t_plain.obj"))
    jv, jf = jmesh.load_obj(str(tmp_path / "t_plain.obj"))
    np.testing.assert_array_equal(lv, jv)
    np.testing.assert_array_equal(lf, jf)
    np.testing.assert_array_equal(lf, faces)
    pv, pf, pc = tmesh.load_ply_mesh(str(tmp_path / "t_colored.ply"))
    np.testing.assert_array_equal(pf, faces)
    np.testing.assert_array_equal(pc, colors)


def test_host_ops_match(sphere):
    pts, vp, vc = sphere
    verts, faces = jmesh.graph_cut_surface(pts, vp, vc)
    np.testing.assert_array_equal(tmesh.vertex_normals(verts, faces), jmesh.vertex_normals(verts, faces))
    for a, b in zip(tmesh.decimate_grid(verts, faces, 0.3), jmesh.decimate_grid(verts, faces, 0.3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tmesh.decimate_qem(verts, faces, 400), jmesh.decimate_qem(verts, faces, 400)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tmesh.merge_meshes(verts, faces, verts + 1e-9, faces, weld_eps=1e-6),
                    jmesh.ops.merge_meshes(verts, faces, verts + 1e-9, faces, weld_eps=1e-6)):
        np.testing.assert_array_equal(a, b)


def test_bake_vertex_colors_matches(sphere):
    pts, vp, vc = sphere
    verts, faces = jmesh.graph_cut_surface(pts, vp, vc)
    rng = np.random.RandomState(4)
    n_views = 4
    ang = np.linspace(0, 2 * np.pi, n_views, endpoint=False)
    c = np.stack([4 * np.cos(ang), 4 * np.sin(ang), np.zeros(n_views)], -1)
    fwd = -c / np.linalg.norm(c, axis=1, keepdims=True)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    R = np.stack([right, np.cross(fwd, right), fwd], axis=-2)
    K = np.tile(np.array([[60.0, 0, 40], [0, 60.0, 30], [0, 0, 1]]), (n_views, 1, 1))
    imgs = [rng.rand(60, 80).astype(np.float32) for _ in range(n_views)]
    imgs[1] = rng.rand(60, 80, 3).astype(np.float32)
    depths = [np.full((60, 80), 3.2, np.float32) for _ in range(n_views)]
    for kw in ({}, {"depth_maps": depths}):
        out = tmesh.bake_vertex_colors(verts, faces, imgs, K, R, c, **kw)
        ref = jmesh.bake_vertex_colors(verts, faces, imgs, K, R, c, **kw)
        assert out.dtype == np.uint8
        np.testing.assert_allclose(out.astype(np.float64), ref.astype(np.float64), atol=1e-5)
        assert (out != 127).any()


@pytest.fixture(scope="module")
def dense_scene(tmp_path_factory):
    """4 rendered views at 320x240 with their ground-truth depth maps at
    160x120 as the filtered maps of a run at downscale 2."""
    d = tmp_path_factory.mktemp("mesh_surface")
    sfm, gt = chip_smoke.make_posed_scene(str(d), n_views=4, wh=(320, 240), focal_px=280.0, n_points=200)
    depth = d / "depth"
    depth.mkdir()
    for v in range(len(gt)):
        np.save(depth / f"{v + 1}_depth.npy", gt[v, ::2, ::2])
    return {"dir": d, "sfm": sfm, "depth": str(depth), "images": str(d / "images")}


@pytest.mark.parametrize("images", [False, True])
def test_meshing_surface_matches(dense_scene, images, monkeypatch):
    """The stage against the JAX stage. The two fusions are float32
    back-projections that differ by an ulp on 41 % of the points, and the
    Delaunay of a cloud on planes turns an ulp into other cells, so the
    stages are first held together from one cloud: the JAX stage is given
    the port's fused cloud (its `fuse_point_cloud` patched for the call).
    Then faces, the colours and every step after the fusion must agree
    (vertices within 1e-5, the Taubin smooth). Each stage on its own cloud:
    face counts within 1 %, half the vertices within 1e-4 of the other
    mesh's."""
    from alicevision_tpu.mvs import fusion as jfusion
    from alicevision_tpu_torch.mvs import fusion as tfusion

    s = dense_scene
    img = s["images"] if images else None
    out_t = str(s["dir"] / f"port_{images}.obj")
    seconds = {}
    v_t, f_t = tstages.meshing_surface(s["sfm"], s["depth"], out_t, max_points=4000, images_folder=img,
                                       device="cpu", seconds=seconds)
    assert v_t.dtype == np.float32 and f_t.dtype == np.int32
    assert set(seconds) >= {"fuse", "delaunay", "cut", "smooth", "write"}
    assert len(f_t) > 200 and f_t.min() >= 0 and f_t.max() < len(v_t)

    def port_cloud(depths, colors, K, R, c, **kw):
        return tfusion.fuse_point_cloud(depths, colors, K, R, c, device="cpu", **kw)

    with monkeypatch.context() as m:
        m.setattr(jfusion, "fuse_point_cloud", port_cloud)
        out_j = str(s["dir"] / f"jax_{images}.obj")
        v_j, f_j = jstages.meshing_surface(s["sfm"], s["depth"], out_j, max_points=4000, images_folder=img)
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_allclose(v_t, v_j, atol=1e-5, rtol=0)
    lv_t, lf_t = tmesh.load_obj(out_t)
    lv_j, lf_j = jmesh.load_obj(out_j)
    np.testing.assert_array_equal(lf_t, lf_j)
    np.testing.assert_allclose(lv_t, lv_j, atol=1e-5, rtol=0)
    with open(out_t) as a, open(out_j) as b:
        head_t, head_j = next(a).split(), next(b).split()
    assert len(head_t) == (7 if images else 4)
    assert head_t[4:] == head_j[4:]  # the baked colour of the first vertex

    v_j, f_j = jstages.meshing_surface(s["sfm"], s["depth"], out_j, max_points=4000, images_folder=img)
    assert abs(len(f_t) - len(f_j)) <= 0.01 * len(f_j)
    near = np.linalg.norm(v_t[:, None] - v_j[None], axis=-1).min(1)
    assert np.median(near) < 1e-4


def test_meshing_surface_needs_depth_maps(dense_scene, tmp_path):
    with pytest.raises(FileNotFoundError):
        tstages.meshing_surface(dense_scene["sfm"], str(tmp_path), str(tmp_path / "m.obj"), device="cpu")


def test_native_raises_without_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        native.maxflow(*_random_graph(0))
    assert not os.path.exists(tmp_path / "_build")
