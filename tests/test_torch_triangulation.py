"""The port's triangulation (`multiview/triangulation.py`) against the JAX
reference on the CPU.

The same numpy inputs (a ring of 6 normalized cameras around random points,
0.5e-3 noise in the normalized plane, random observation masks and a few
gross outliers, all drawn with numpy) go through the jitted JAX functions
and the port with CPU tensors. The rays are well conditioned (views 0.3 rad
apart or more), where float32 eigh agrees between the libraries to ~1e-5;
points are held at atol 1e-4 (scene radius ~2).
"""

import jax
import numpy as np
import pytest
import torch

from alicevision_tpu import multiview as jmv
from alicevision_tpu_torch import multiview as tmv

torch.set_num_threads(1)

ATOL = 1e-4
K, T = 6, 64

j_dlt = jax.jit(jmv.triangulate_dlt)
j_nview = jax.jit(jmv.triangulate_nview)
j_mid = jax.jit(jmv.triangulate_midpoint)
j_err = jax.jit(jmv.reprojection_errors)
j_depths = jax.jit(jmv.depths)
j_robust = jax.jit(jmv.triangulate_nview_robust, static_argnames=("threshold_px", "max_pairs", "lo_iters"))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def scene():
    """K cameras on a ring of radius 6 looking at the origin, T points in a
    cube of side 4: projections (K, 3, 4), centres, observations (T, K, 2)
    with noise, a mask with >= 2 views a track, and 10 % gross outliers."""
    rng = np.random.RandomState(0)
    X = rng.uniform(-2, 2, (T, 3))
    P, C = [], []
    for k in range(K):
        a = 0.3 * k
        R = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])
        c = -6.0 * R[2]
        P.append(np.concatenate([R, -(R @ c)[:, None]], 1))
        C.append(c)
    P, C = np.array(P), np.array(C)
    xc = np.einsum("kij,tj->tki", P, np.concatenate([X, np.ones((T, 1))], 1))
    x = xc[..., :2] / xc[..., 2:] + 5e-4 * rng.randn(T, K, 2)
    mask = rng.rand(T, K) < 0.7
    mask[:, :2] = True
    out = (rng.rand(T, K) < 0.1) & mask
    out[:, :2] = False
    x_out = np.where(out[..., None], x + rng.uniform(-0.2, 0.2, x.shape), x)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    Pb = np.broadcast_to(P, (T, K, 3, 4))
    return dict(X=X, P=f32(P), Pb=f32(Pb), C=f32(np.broadcast_to(C, (T, K, 3))), x=f32(x),
                x_out=f32(x_out), mask=mask, out=out)


def test_triangulate_dlt(scene):
    P1, P2 = scene["Pb"][:, 0], scene["Pb"][:, 3]
    x1, x2 = scene["x"][:, 0], scene["x"][:, 3]
    X_t = tmv.triangulate_dlt(t(P1), t(P2), t(x1), t(x2)).numpy()
    X_j = np.asarray(j_dlt(P1, P2, x1, x2))
    np.testing.assert_allclose(X_t, X_j, atol=ATOL)
    np.testing.assert_allclose(X_t, scene["X"], atol=0.05)


@pytest.mark.parametrize("masked", [False, True])
def test_triangulate_nview(scene, masked):
    mask = scene["mask"] if masked else None
    X_t = tmv.triangulate_nview(t(scene["Pb"]), t(scene["x"]), None if mask is None else t(mask)).numpy()
    X_j = np.asarray(j_nview(scene["Pb"], scene["x"], mask))
    np.testing.assert_allclose(X_t, X_j, atol=ATOL)
    np.testing.assert_allclose(X_t, scene["X"], atol=0.02)


def test_triangulate_midpoint(scene):
    # rays through the noisy observations, in the world frame
    R = scene["P"][:, :, :3]
    d = np.einsum("kji,tkj->tki", R, np.concatenate([scene["x"], np.ones((T, K, 1), np.float32)], -1))
    d = d.astype(np.float32)
    for mask in (None, scene["mask"]):
        X_t = tmv.triangulate_midpoint(t(scene["C"]), t(d), None if mask is None else t(mask)).numpy()
        X_j = np.asarray(j_mid(scene["C"], d, mask))
        np.testing.assert_allclose(X_t, X_j, atol=ATOL)


def test_reprojection_errors_and_depths(scene):
    X = scene["X"].astype(np.float32)
    e_t = tmv.reprojection_errors(t(scene["Pb"]), t(scene["x_out"]), t(X)).numpy()
    e_j = np.asarray(j_err(scene["Pb"], scene["x_out"], X))
    np.testing.assert_allclose(e_t, e_j, rtol=1e-5, atol=1e-6)
    d_t = tmv.depths(t(scene["Pb"]), t(X)).numpy()
    np.testing.assert_allclose(d_t, np.asarray(j_depths(scene["Pb"], X)), rtol=1e-6, atol=1e-5)


def test_triangulate_nview_robust(scene):
    kw = dict(threshold_px=4e-3, max_pairs=15, lo_iters=2)
    X_t, inl_t, val_t = tmv.triangulate_nview_robust(t(scene["Pb"]), t(scene["x_out"]), t(scene["mask"]), **kw)
    X_j, inl_j, val_j = j_robust(scene["Pb"], scene["x_out"], scene["mask"], **kw)
    np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(X_t.numpy(), np.asarray(X_j), atol=ATOL)
    # the outliers are voted out
    assert not (inl_t.numpy() & scene["out"]).any()
