"""The port's essential, relative-pose and resection estimators
(`robust/estimators.py`) against the JAX reference on the CPU.

Two views of random points (normalized coordinates, 0.3 px noise at a
1000 px focal, 25 % gross outliers) and 60-point resection problems are
drawn with numpy. The two libraries' random streams differ, so the port is
handed the reference's minimal-sample indices (`idx`), drawn by the same
`sample_minimal` call with the same key as inside the JAX estimator. Both
then select from the same hypotheses: they are held to the same inlier
masks and counts, the best hypothesis' NFA and threshold at rtol 1e-3,
E up to sign and R, t within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu import robust as jrb
from alicevision_tpu.geometry.rotations import so3_exp as j_so3_exp
from alicevision_tpu_torch import robust as trb

torch.set_num_threads(1)

FOCAL, IM = 1000.0, (1920.0, 1080.0)
N_HYPS = 64
TOL = 1e-3

_static = ("im_size", "n_hyps", "max_error_px")
j_re = jax.jit(jrb.robust_essential, static_argnames=_static + ("solver",))
j_rp = jax.jit(jrb.robust_relative_pose, static_argnames=_static + ("solver",))
j_rr = jax.jit(jrb.robust_resection_p3p, static_argnames=_static + ("refine_iters",))
j_sample = jax.jit(jrb.sample_minimal, static_argnums=(1, 2, 3))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _up_to_sign(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    s = np.sign(np.sum(a * b, axis=(-2, -1), keepdims=True))
    np.testing.assert_allclose(a, s * b, atol=atol)


@pytest.fixture(scope="module")
def pair():
    """Normalized correspondences of 120 points between two views 0.4 rad
    apart around them (noise, 25 % outliers), the last 10 slots padding."""
    rng = np.random.RandomState(0)
    X = rng.uniform(-2, 2, (120, 3))

    def view(a):
        R = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])
        c = -8.0 * R[2]
        xc = (X - c) @ R.T
        return xc[:, :2] / xc[:, 2:], R, c

    x1, R1, c1 = view(0.0)
    x2, R2, c2 = view(0.4)
    x2 = x2 + 0.3 / FOCAL * rng.randn(*x2.shape)
    out = rng.rand(120) < 0.25
    x2[out] = rng.uniform(-0.4, 0.4, (out.sum(), 2))
    valid = np.arange(120) < 110
    R = R2 @ R1.T
    tr = R2 @ (c1 - c2)
    return x1.astype(np.float32), x2.astype(np.float32), valid, out, R, tr / np.linalg.norm(tr)


@pytest.mark.parametrize("solver,size", [("5pt", 5), ("8pt", 8)])
def test_robust_essential(pair, solver, size):
    x1, x2, valid, out, _, _ = pair
    key = jax.random.PRNGKey(1)
    rm_j = j_re(key, x1, x2, FOCAL, IM, valid, n_hyps=N_HYPS, max_error_px=4.0, solver=solver)
    idx = np.asarray(j_sample(key, 120, size, N_HYPS, jnp.asarray(valid)))
    rm_t = trb.robust_essential(None, t(x1), t(x2), FOCAL, IM, t(valid), n_hyps=N_HYPS, max_error_px=4.0,
                                solver=solver, idx=t(idx))
    np.testing.assert_array_equal(rm_t.inliers.numpy(), np.asarray(rm_j.inliers))
    assert int(rm_t.n_inliers) == int(rm_j.n_inliers)
    # the same best hypothesis: its NFA and adaptive threshold
    np.testing.assert_allclose(float(rm_t.nfa), float(rm_j.nfa), rtol=TOL)
    np.testing.assert_allclose(float(rm_t.threshold_sq), float(rm_j.threshold_sq), rtol=TOL)
    _up_to_sign(rm_t.model.numpy(), rm_j.model, TOL)
    inl = rm_t.inliers.numpy()
    assert not (inl & out).any() and inl.sum() > 0.9 * (valid & ~out).sum()


def test_robust_relative_pose(pair):
    x1, x2, valid, _, R_true, t_true = pair
    key = jax.random.PRNGKey(2)
    R_j, t_j, rm_j = j_rp(key, x1, x2, FOCAL, IM, valid, n_hyps=N_HYPS, max_error_px=4.0)
    idx = np.asarray(j_sample(key, 120, 5, N_HYPS, jnp.asarray(valid)))
    R_t, t_t, rm_t = trb.robust_relative_pose(None, t(x1), t(x2), FOCAL, IM, t(valid), n_hyps=N_HYPS,
                                              max_error_px=4.0, idx=t(idx))
    np.testing.assert_array_equal(rm_t.inliers.numpy(), np.asarray(rm_j.inliers))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=TOL)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=TOL)
    np.testing.assert_allclose(R_t.numpy(), R_true, atol=2e-2)  # 0.3 px noise, 0.4 rad baseline
    np.testing.assert_allclose(t_t.numpy(), t_true, atol=2e-2)


def test_robust_relative_pose_batch(pair):
    """Three problems in one call: the pair, the pair swapped, and the
    pair with 30 more slots of padding."""
    x1, x2, valid, _, _, _ = pair
    X1 = np.stack([x1, x2, x1])
    X2 = np.stack([x2, x1, x2])
    V = np.stack([valid, valid, np.arange(120) < 80])
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    res_j = jrb.robust_relative_pose_batch(keys, jnp.asarray(X1), jnp.asarray(X2), FOCAL, IM, jnp.asarray(V),
                                           n_hyps=N_HYPS)
    idx = np.asarray(jax.vmap(lambda k, v: jrb.sample_minimal(k, 120, 5, N_HYPS, v))(keys, jnp.asarray(V)))
    res_t = trb.robust_relative_pose_batch(None, t(X1), t(X2), FOCAL, IM, t(V), n_hyps=N_HYPS, idx=t(idx))
    assert res_t.R.shape == (3, 3, 3) and res_t.inliers.shape == (3, 120)
    np.testing.assert_array_equal(res_t.inliers.numpy(), np.asarray(res_j.inliers))
    np.testing.assert_array_equal(res_t.n_inliers.numpy(), np.asarray(res_j.n_inliers))
    np.testing.assert_allclose(res_t.R.numpy(), np.asarray(res_j.R), atol=TOL)
    np.testing.assert_allclose(res_t.t.numpy(), np.asarray(res_j.t), atol=TOL)


@pytest.fixture(scope="module")
def resection():
    """Four 60-point resection problems: world points 4-8 units in front of
    the camera, 0.3 px noise, 20 % outliers, the last slots padding."""
    rng = np.random.RandomState(4)
    B, N = 4, 60
    R = np.asarray(jax.vmap(j_so3_exp)(jnp.asarray(0.3 * rng.randn(B, 3), jnp.float32)))
    tt = np.c_[0.3 * rng.randn(B, 2), rng.uniform(5, 6, B)]
    Xc = np.concatenate([rng.uniform(-2, 2, (B, N, 2)), rng.uniform(-1, 1, (B, N, 1))], -1)
    Xc[..., 2] += tt[:, None, 2]
    world = np.einsum("bji,bnj->bni", R, Xc - tt[:, None, :])
    obs = Xc[..., :2] / Xc[..., 2:] + 0.3 / FOCAL * rng.randn(B, N, 2)
    out = rng.rand(B, N) < 0.2
    obs[out] = rng.uniform(-0.4, 0.4, (out.sum(), 2))
    valid = np.arange(N)[None, :] < np.array([60, 55, 50, 45])[:, None]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(world), f32(obs), valid, out, R, f32(tt)


def test_robust_resection_p3p(resection):
    world, obs, valid, out, R, tt = resection
    key = jax.random.PRNGKey(5)
    rp_j = j_rr(key, world[0], obs[0], FOCAL, IM, valid[0], n_hyps=N_HYPS, max_error_px=8.0)
    idx = np.asarray(j_sample(key, 60, 3, N_HYPS, jnp.asarray(valid[0])))
    rp_t = trb.robust_resection_p3p(None, t(world[0]), t(obs[0]), FOCAL, IM, t(valid[0]), n_hyps=N_HYPS,
                                    max_error_px=8.0, idx=t(idx))
    np.testing.assert_array_equal(rp_t.inliers.numpy(), np.asarray(rp_j.inliers))
    np.testing.assert_allclose(float(rp_t.nfa), float(rp_j.nfa), rtol=TOL)
    np.testing.assert_allclose(float(rp_t.threshold_sq), float(rp_j.threshold_sq), rtol=TOL)
    np.testing.assert_allclose(rp_t.R.numpy(), np.asarray(rp_j.R), atol=TOL)
    np.testing.assert_allclose(rp_t.t.numpy(), np.asarray(rp_j.t), atol=TOL)
    np.testing.assert_allclose(rp_t.R.numpy(), R[0], atol=5e-3)
    assert not (rp_t.inliers.numpy() & out[0]).any()


def test_robust_resection_p3p_batch(resection):
    world, obs, valid, out, R, tt = resection
    keys = jax.random.split(jax.random.PRNGKey(6), 4)
    rp_j = jrb.robust_resection_p3p_batch(keys, jnp.asarray(world), jnp.asarray(obs), FOCAL, IM,
                                          jnp.asarray(valid), n_hyps=N_HYPS, max_error_px=8.0)
    idx = np.asarray(jax.vmap(lambda k, v: jrb.sample_minimal(k, 60, 3, N_HYPS, v))(keys, jnp.asarray(valid)))
    rp_t = trb.robust_resection_p3p_batch(None, t(world), t(obs), FOCAL, IM, t(valid), n_hyps=N_HYPS,
                                          max_error_px=8.0, idx=t(idx))
    np.testing.assert_array_equal(rp_t.inliers.numpy(), np.asarray(rp_j.inliers))
    np.testing.assert_array_equal(rp_t.n_inliers.numpy(), np.asarray(rp_j.n_inliers))
    np.testing.assert_allclose(rp_t.R.numpy(), np.asarray(rp_j.R), atol=TOL)
    np.testing.assert_allclose(rp_t.t.numpy(), np.asarray(rp_j.t), atol=TOL)
    np.testing.assert_allclose(rp_t.t.numpy(), tt, atol=0.05)
