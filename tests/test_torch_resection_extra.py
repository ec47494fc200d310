"""The port's remaining resection solvers (`multiview/resection.py`:
`resection_dlt6`, `epnp`, `p4pf`, `p5pfr`, and `numeric.skew`) against the
JAX reference on the CPU.

Poses and points are drawn with numpy; both packages get the same float32
inputs (JAX's functions jitted once). The DLT and EPnP poses are held to
JAX's within 1e-3 (R) and 2e-3 (t), and to the truth within 5e-3 and
5e-2 (0.2 px of noise at a 900 px focal). P4Pf and P5Pfr keep
the `top_k` best of a focal (x k1) grid, and `torch.topk` may order tied
scores differently from `lax.top_k`, so their valid candidates are
compared as sets: every valid JAX candidate has a port candidate within
1e-3 in R, 1e-2 in t and 1e-3 relative in f (and 1e-3 in k1), on
well-conditioned samples (points spread 4-8 units in front of the camera,
the focal inside the grid), and both recover the true focal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu import multiview as jmv
from alicevision_tpu import numeric as jnum
from alicevision_tpu.geometry.rotations import so3_exp as j_so3_exp
from alicevision_tpu_torch import multiview as tmv
from alicevision_tpu_torch import numeric as tnum

torch.set_num_threads(1)

FOCAL = 900.0
F_LO, F_HI = 450.0, 1800.0
K1_TRUE = -0.2

j_dlt6 = jax.jit(jmv.resection_dlt6)
j_epnp = jax.jit(jmv.epnp)
j_p4pf = jax.jit(jmv.p4pf, static_argnames=("f_lo", "f_hi", "n_f", "top_k"))
j_p5pfr = jax.jit(jmv.p5pfr, static_argnames=("f_lo", "f_hi", "n_f", "n_k", "top_k"))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _problem(seed, B, N):
    """B poses looking down +z at N points 4-8 units away: (R, t, world
    (B, N, 3), normalized observations (B, N, 2)), float32."""
    rng = np.random.RandomState(seed)
    R = np.asarray(jax.vmap(j_so3_exp)(jnp.asarray(rng.randn(B, 3) * 0.4, jnp.float32)))
    tt = np.c_[rng.randn(B, 2) * 0.3, rng.uniform(5, 7, B)].astype(np.float32)
    Xc = np.c_[rng.uniform(-2, 2, (B * N, 2)), rng.uniform(-1, 1, B * N)].reshape(B, N, 3)
    Xc[..., 2] += tt[:, None, 2]
    world = np.einsum("bji,bnj->bni", R, Xc - tt[:, None, :]).astype(np.float32)
    obs = (Xc[..., :2] / Xc[..., 2:]).astype(np.float32)
    return R, tt, world, obs


def _distort(obs_norm, k1):
    """Division-model distortion: x_d with x_u = x_d / (1 + k1 |x_d|^2)."""
    r_u = np.linalg.norm(obs_norm, axis=-1, keepdims=True)
    r_d = (1.0 - np.sqrt(1.0 - 4.0 * k1 * r_u**2)) / (2.0 * k1 * np.maximum(r_u, 1e-12))
    return obs_norm * (r_d / np.maximum(r_u, 1e-12))


def test_skew():
    v = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    np.testing.assert_allclose(tnum.skew(t(v)).numpy(), np.asarray(jnum.skew(jnp.asarray(v))), atol=0)
    w = np.random.RandomState(1).randn(5, 3).astype(np.float32)
    np.testing.assert_allclose((tnum.skew(t(v)) @ t(w)[..., None])[..., 0].numpy(), np.cross(v, w), atol=1e-5)


@pytest.mark.parametrize("name,N", [("dlt6", 8), ("epnp", 10)])
def test_linear_resection(name, N):
    R, tt, world, obs = _problem(0, 16, N)
    obs = obs + np.random.RandomState(5).randn(*obs.shape).astype(np.float32) * (0.2 / FOCAL)
    mask = np.broadcast_to(np.arange(N) != N - 1, (16, N)).copy()
    jf, tf = (j_dlt6, tmv.resection_dlt6) if name == "dlt6" else (j_epnp, tmv.epnp)
    for m in (None, mask):
        R_j, t_j, ok_j = jf(world, obs, m)
        R_t, t_t, ok_t = tf(t(world), t(obs), None if m is None else t(m))
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        assert ok_t.all()
        np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-3)
        np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=2e-3)
        np.testing.assert_allclose(R_t.numpy(), R, atol=5e-3)
        np.testing.assert_allclose(t_t.numpy(), tt, atol=5e-2)


def _assert_candidate_sets(port, ref, tols):
    """Every valid reference candidate of each sample has a valid port
    candidate within `tols` (one per array), and the valid counts agree."""
    *p_arrays, p_ok = port
    *r_arrays, r_ok = ref
    for b in range(r_ok.shape[0]):
        assert p_ok[b].sum() == r_ok[b].sum(), b
        for k in np.nonzero(r_ok[b])[0]:
            hit = False
            for m in np.nonzero(p_ok[b])[0]:
                if all(np.all(np.abs(pa[b, m] - ra[b, k]) <= tol * (np.abs(ra[b, k]) if rel else 1.0))
                       for pa, ra, (tol, rel) in zip(p_arrays, r_arrays, tols)):
                    hit = True
                    break
            assert hit, (b, k)


def test_p4pf():
    _, _, world, obs = _problem(1, 24, 4)
    obs_px = (obs * FOCAL).astype(np.float32)
    R_j, t_j, f_j, ok_j = (np.asarray(x) for x in j_p4pf(world, obs_px, f_lo=F_LO, f_hi=F_HI))
    R_t, t_t, f_t, ok_t = (x.numpy() for x in tmv.p4pf(t(world), t(obs_px), F_LO, F_HI))
    assert R_t.shape == (24, 4, 3, 3) and f_t.shape == (24, 4)
    _assert_candidate_sets((R_t, t_t, f_t, ok_t), (R_j, t_j, f_j, ok_j),
                           [(1e-3, False), (1e-2, False), (1e-3, True)])
    # the true focal is among the valid candidates of nearly every sample
    near = np.any(ok_t & (np.abs(f_t - FOCAL) < 1e-2 * FOCAL), axis=-1)
    near_j = np.any(ok_j & (np.abs(f_j - FOCAL) < 1e-2 * FOCAL), axis=-1)
    np.testing.assert_array_equal(near, near_j)
    assert near.mean() >= 0.9


def test_p5pfr():
    _, _, world, obs = _problem(2, 16, 5)
    obs_px = (_distort(obs.astype(np.float64), K1_TRUE) * FOCAL).astype(np.float32)
    R_j, t_j, f_j, k_j, ok_j = (np.asarray(x) for x in j_p5pfr(world, obs_px, f_lo=F_LO, f_hi=F_HI))
    R_t, t_t, f_t, k_t, ok_t = (x.numpy() for x in tmv.p5pfr(t(world), t(obs_px), F_LO, F_HI))
    assert k_t.shape == (16, 4)
    _assert_candidate_sets((R_t, t_t, f_t, k_t, ok_t), (R_j, t_j, f_j, k_j, ok_j),
                           [(1e-3, False), (1e-2, False), (1e-3, True), (1e-3, False)])
    near = np.any(ok_t & (np.abs(f_t - FOCAL) < 1e-2 * FOCAL) & (np.abs(k_t - K1_TRUE) < 1e-2), axis=-1)
    assert near.mean() >= 0.9
