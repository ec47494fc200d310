"""The port's rotation-only and global SfM (`sfm/rotation_sfm.py`,
`sfm/global_sfm.py`) against the JAX package's, on the CPU.

The port draws RANSAC samples from a `torch.Generator`; here it gets JAX's
`sample_minimal` indices (the keys split as `RotationSfM.run` splits
them). Tolerances: relative rotations within 0.01 deg and the same inlier
sets (within 3 of 150 on noise-free bearings, whose residuals are all
float32 rounding); averaged rotations within 0.01 deg after aligning the gauge (the
eigenvectors' sign and order may differ between the two `eigh`s), 0.05 deg
for the IRLS and L1 solutions, whose reweighting amplifies float32
rounding; camera centres within 1e-4 of the scene's extent; the refined
rotations within 0.01 deg. Scenes: tests/test_rotation_misc.py's rotating
camera, tests/test_global_sfm.py's ring and its L1 scenes,
tests/test_stats_alignment_io.py's constraints.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu import geometry as jgeo
from alicevision_tpu import sfmdata as jsfmdata
from alicevision_tpu.robust.ransac import sample_minimal
from alicevision_tpu.sfm import global_sfm as jgs
from alicevision_tpu.sfm import rotation_sfm as jrs
from alicevision_tpu.utils.synthetic import ring_scene
from alicevision_tpu_torch.sfm import global_sfm as tgs
from alicevision_tpu_torch.sfm import rotation_sfm as trs

torch.set_num_threads(1)


def _angle_deg(A, B):
    """Angles (deg) between rotation stacks A and B, from both the skew and
    the trace part of A B^T (the trace alone loses small angles to float32
    rounding)."""
    M = np.asarray(A, np.float64) @ np.swapaxes(np.asarray(B, np.float64), -1, -2)
    skew = np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0], M[:, 1, 0] - M[:, 0, 1]], -1)
    return np.degrees(np.arctan2(0.5 * np.linalg.norm(skew, axis=-1), 0.5 * (np.trace(M, axis1=1, axis2=2) - 1)))


def _gauge_err_deg(R_a, R_b):
    """Largest angle between two rotation sets after mapping a's gauge to
    b's through view 0 (R_v -> R_v R_a0^T R_b0)."""
    align = R_a[0].T @ R_b[0]
    return float(_angle_deg(np.asarray(R_a) @ align, R_b).max())


def _rotating_camera_bearings(n_views=6, n_pts=150, seed=0, outlier_frac=0.0):
    """tests/test_rotation_misc.py's purely rotating camera."""
    k1, _ = jax.random.split(jax.random.PRNGKey(seed))
    dirs = jax.random.normal(k1, (n_pts, 3))
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    Rs = [np.asarray(jgeo.so3_exp(jnp.asarray([0.05 * v, 0.8 * v / n_views * 2 * np.pi, -0.03 * v])))
          for v in range(n_views)]
    bearings = [np.array(jnp.einsum("ij,nj->ni", jnp.asarray(R), dirs)) for R in Rs]
    if outlier_frac > 0:
        rng = np.random.RandomState(seed)
        for b in bearings[1:]:
            n_out = int(outlier_frac * n_pts)
            idx = rng.choice(n_pts, n_out, replace=False)
            r = rng.randn(n_out, 3)
            b[idx] = r / np.linalg.norm(r, axis=-1, keepdims=True)
    return Rs, bearings


def _t(a):
    return torch.from_numpy(np.array(a))


def test_kabsch_rotation_only_matches():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(4, 9, 3)).astype(np.float32)
    dst = rng.normal(size=(4, 9, 3)).astype(np.float32)
    mask = rng.random((4, 9)) > 0.3
    for m in (None, mask):
        rj = np.asarray(jrs._kabsch_rotation_only(jnp.asarray(src), jnp.asarray(dst),
                                                  None if m is None else jnp.asarray(m)))
        rt = trs._kabsch_rotation_only(_t(src), _t(dst), None if m is None else _t(m)).numpy()
        np.testing.assert_allclose(rt, rj, atol=1e-5)


def test_robust_rotation_matches():
    Rs, bearings = _rotating_camera_bearings(outlier_frac=0.25, seed=1)
    key = jax.random.PRNGKey(0)
    b1, b2 = bearings[0], bearings[2]
    Rj, inl_j, _ = jrs.robust_rotation(key, jnp.asarray(b1), jnp.asarray(b2), focal_px=1000.0,
                                       im_size=(1920, 1080))
    idx = np.asarray(sample_minimal(key, len(b1), 2, 128, None))
    Rt, inl_t, _ = trs.robust_rotation(None, _t(b1), _t(b2), focal_px=1000.0, im_size=(1920, 1080), idx=_t(idx))
    assert _angle_deg(Rt.numpy()[None], np.asarray(Rj)[None])[0] < 0.01
    assert np.array_equal(inl_t.numpy(), np.asarray(inl_j)) and int(inl_t.sum()) > 100
    assert _angle_deg(Rt.numpy()[None], (Rs[2] @ Rs[0].T)[None])[0] < 0.2


def test_rotation_sfm_engine_matches():
    Rs, bearings = _rotating_camera_bearings(n_views=5, seed=2)
    pairs = {(i, j): (bearings[i], bearings[j]) for i in range(5) for j in range(i + 1, 5)}
    key = jax.random.PRNGKey(1)
    Rj, cj = jrs.RotationSfM(5, 1000.0, (1920, 1080)).run(key, pairs)
    idx = {}
    for p, (bi, _) in pairs.items():  # the keys as RotationSfM.run splits them
        key, k = jax.random.split(key)
        idx[p] = np.asarray(sample_minimal(k, len(bi), 2, 128, None))
    Rt, ct = trs.RotationSfM(5, 1000.0, (1920, 1080), device="cpu").run(None, pairs, idx=idx)
    # noise-free bearings: every residual is float32 rounding, and the
    # a-contrario threshold falls among them, so a few inliers may flip
    assert ct.keys() == cj.keys() and all(abs(ct[p] - cj[p]) <= 3 for p in cj)
    assert _gauge_err_deg(Rt, Rj) < 0.01
    assert _gauge_err_deg(Rt, np.stack(Rs)) < 0.3


def _gt_edges(scene, n_views, extra_noise_deg=0.0, outlier_frac=0.0, seed=0):
    """tests/test_global_sfm.py's relative motions of a ring scene."""
    rng = np.random.RandomState(seed)
    R_gt, c_gt = np.asarray(scene.poses.R), np.asarray(scene.poses.c)
    edges, R_rel, dirs_ref = [], [], []
    for i in range(n_views):
        for j in range(i + 1, n_views):
            Rr, d_world = jgs.relative_motions_from_poses(R_gt[i], R_gt[j], c_gt[i], c_gt[j])
            if extra_noise_deg > 0:
                Rr = np.asarray(jgeo.so3_exp(jnp.asarray(np.radians(extra_noise_deg) * rng.randn(3)))) @ Rr
            if outlier_frac > 0 and rng.rand() < outlier_frac:
                Rr = np.asarray(jgeo.random_rotation(jax.random.PRNGKey(rng.randint(1e6))))
            edges.append((i, j))
            R_rel.append(Rr)
            dirs_ref.append(R_gt[i] @ d_world)
    return np.array(edges), np.stack(R_rel).astype(np.float32), np.stack(dirs_ref)


@pytest.mark.parametrize("case", ["exact", "noisy", "irls"])
def test_rotation_averaging_l2_matches(case):
    # one view count for the three cases, so that JAX compiles its eager
    # operations once
    n = 10
    scene = ring_scene(n_views=n, n_points=10)
    kw = {"exact": {}, "noisy": dict(extra_noise_deg=2.0), "irls": dict(extra_noise_deg=0.5, outlier_frac=0.15,
                                                                          seed=2)}[case]
    edges, R_rel, _ = _gt_edges(scene, n, **kw)
    iters = 4 if case == "irls" else 0
    Rj = np.asarray(jgs.rotation_averaging_l2(n, edges, jnp.asarray(R_rel), irls_iters=iters))
    Rt = tgs.rotation_averaging_l2(n, edges, _t(R_rel), irls_iters=iters).numpy()
    assert _gauge_err_deg(Rt, Rj) < (0.05 if iters else 0.01)
    np.testing.assert_allclose(Rt[0], np.eye(3), atol=1e-5)  # the gauge: R_0 = I
    res_j = np.asarray(jgs.rotation_residuals_deg(jnp.asarray(Rj), edges, jnp.asarray(R_rel)))
    res_t = tgs.rotation_residuals_deg(_t(Rt), edges, _t(R_rel)).numpy()
    np.testing.assert_allclose(np.sort(res_t), np.sort(res_j), atol=0.05)


def test_rotation_averaging_l1_matches():
    """tests/test_global_sfm.py's 8 views with 15 % corrupted edges."""
    rng = np.random.default_rng(0)
    n = 8
    R_gt = np.array([np.asarray(jgeo.so3_exp(jnp.asarray(rng.normal(size=3) * 0.5, jnp.float32)))
                     for _ in range(n)])
    edges = np.array([(i, j) for i in range(n) for j in range(i + 1, n)])
    rels = np.array([R_gt[j] @ R_gt[i].T for i, j in edges], np.float32)
    n_bad = int(0.15 * len(edges))
    for e in range(n_bad):
        rels[e] = np.asarray(jgeo.so3_exp(jnp.asarray(rng.normal(size=3) * 2.0, jnp.float32))) @ rels[e]
    Rj = np.asarray(jgs.rotation_averaging_l1(n, edges, jnp.asarray(rels)))
    Rt = tgs.rotation_averaging_l1(n, edges, _t(rels)).numpy()
    assert _gauge_err_deg(Rt, Rj) < 0.05
    res = tgs.rotation_residuals_deg(_t(Rt), edges, _t(rels)).numpy()
    assert np.median(res[n_bad:]) < 0.5


def _centre_err(c, ref):
    """Largest distance between two centre sets after removing their means,
    in units of ref's extent."""
    c0, r0 = c - c.mean(0), ref - ref.mean(0)
    return float(np.linalg.norm(c0 - r0, axis=-1).max() / np.linalg.norm(r0, axis=-1).max())


def test_translation_averaging_matches():
    scene = ring_scene(n_views=8, n_points=10)
    c_gt = np.asarray(scene.poses.c)
    edges, _, _ = _gt_edges(scene, 8)
    d = c_gt[edges[:, 1]] - c_gt[edges[:, 0]]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    cj = np.asarray(jgs.translation_averaging_l2(8, edges, jnp.asarray(d)))
    ct = tgs.translation_averaging_l2(8, edges, d, device="cpu").numpy()
    assert _centre_err(ct, cj) < 1e-4
    assert np.allclose(tgs.translation_averaging_l2(8, edges, _t(d)).numpy(), ct)
    # tests/test_global_sfm.py's soft-L1 scene, 3 corrupted directions
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(8, 3)) * 3.0
    dirs = np.array([(centers[j] - centers[i]) / np.linalg.norm(centers[j] - centers[i]) for i, j in edges])
    for e in range(3):
        v = rng.normal(size=3)
        dirs[e] = v / np.linalg.norm(v)
    cj = np.asarray(jgs.translation_averaging_l1soft(8, edges, jnp.asarray(dirs)))
    ct = tgs.translation_averaging_l1soft(8, edges, dirs.astype(np.float32), device="cpu").numpy()
    assert _centre_err(ct, cj) < 1e-4


def test_global_sfm_engine_matches():
    scene = ring_scene(n_views=8, n_points=10)
    edges, R_rel, dirs_ref = _gt_edges(scene, 8, extra_noise_deg=0.3)
    sizes = np.tile([1920, 1080], (8, 1))
    Rj, cj = jgs.GlobalSfM(8, None, np.zeros(8), sizes).run(edges, R_rel, dirs_ref, irls_iters=2)
    Rt, ct = tgs.GlobalSfM(8, None, np.zeros(8), sizes, device="cpu").run(edges, R_rel, dirs_ref, irls_iters=2)
    assert _gauge_err_deg(Rt, np.asarray(Rj)) < 0.05
    assert _centre_err(ct, np.asarray(cj)) < 1e-3
    assert _gauge_err_deg(Rt, np.asarray(scene.poses.R)) < 1.5
    a, b = jgs.relative_motions_from_poses(Rt[0], Rt[1], ct[0], ct[1]), tgs.relative_motions_from_poses(
        Rt[0], Rt[1], ct[0], ct[1])
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_refine_rotations_with_constraints_matches():
    """tests/test_stats_alignment_io.py's priors and 2D constraints."""
    rng = np.random.default_rng(0)
    V = 4
    R_gt = np.asarray(jgeo.so3_exp(jnp.asarray(rng.normal(0, 0.3, (V, 3)).astype(np.float32))))
    sc = jsfmdata.SfMData.empty()
    sc.add_intrinsic(1000, 640, 480, 400.0)
    for v in range(V):
        sc.add_view(v + 1, 0, 640, 480)
    priors = [{"view_i": v, "view_j": v + 1, "R_j_i": R_gt[v + 1] @ R_gt[v].T} for v in range(V - 1)]
    cons = []
    for _ in range(12):  # about 12 constraints: JAX computes each bearing eagerly
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        for v in range(V - 1):
            bi, bj = R_gt[v] @ d, R_gt[v + 1] @ d
            if bi[2] >= 0.3 and bj[2] >= 0.3:
                cons.append({"view_i": v, "uv_i": 400.0 * bi[:2] / bi[2] + [320, 240],
                             "view_j": v + 1, "uv_j": 400.0 * bj[:2] / bj[2] + [320, 240]})
    dw = rng.normal(0, 0.03, (V, 3)).astype(np.float32)
    dw[0] = 0
    R_pert = np.asarray(jgeo.so3_exp(jnp.asarray(dw))) @ R_gt
    intr = sc.intrinsics_table()
    Rj = jrs.refine_rotations_with_constraints(R_pert, priors, cons, intr=intr, view_intrinsic=sc.view_intrinsic)
    Rt = trs.refine_rotations_with_constraints(R_pert, priors, cons, intr=[np.asarray(x) for x in intr],
                                               view_intrinsic=sc.view_intrinsic, device="cpu")
    assert _angle_deg(Rt, Rj).max() < 0.01
    assert _angle_deg(Rt, R_gt).max() < 0.15
