"""The port's rotation and pose functions against the JAX reference, on the
CPU, on random inputs including angles near 0 and near pi. Rotations are
compared as matrices (a quaternion's sign is free) within atol 1e-6;
float32 rounding of the same closed forms stays well inside it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu import geometry as jgeo
from alicevision_tpu_torch import geometry as tgeo

torch.set_num_threads(1)

ATOL = 1e-6


def _axis_angles(seed, n=64):
    """Rotation vectors with angles spread over (0, pi), plus angles within
    1e-5 of 0 (the Taylor branches) and within 1e-3 of pi."""
    rng = np.random.RandomState(seed)
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = np.concatenate([
        rng.uniform(0.0, np.pi, n - 16),
        rng.uniform(0.0, 1e-5, 8),
        np.pi - rng.uniform(0.0, 1e-3, 8),
    ])
    return (axis * ang[:, None]).astype(np.float32)


def _j(fn, *xs):
    return np.asarray(fn(*(jnp.asarray(x) for x in xs)))


def _t(fn, *xs):
    return fn(*(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)).numpy()


def _mat(q):
    return _j(jgeo.quat_to_mat, q)


def test_so3_exp_matches():
    w = _axis_angles(0)
    np.testing.assert_allclose(_t(tgeo.so3_exp, w), _j(jgeo.so3_exp, w), atol=ATOL)


def test_so3_log_matches():
    R = _j(jgeo.so3_exp, _axis_angles(1))
    out, ref = _t(tgeo.so3_log, R), _j(jgeo.so3_log, R)
    # near pi, w and -w name the same rotation: hold exp(log R) instead
    np.testing.assert_allclose(_j(jgeo.so3_exp, out), _j(jgeo.so3_exp, ref), atol=1e-5)
    small = np.linalg.norm(ref, axis=1) < 3.0
    np.testing.assert_allclose(out[small], ref[small], atol=1e-5)


def test_mat_to_quat_matches():
    R = _j(jgeo.so3_exp, _axis_angles(2))
    q_t, q_j = _t(tgeo.mat_to_quat, R), _j(jgeo.mat_to_quat, R)
    assert (q_t[:, 0] >= 0).all()  # the canonical sign, as the reference
    np.testing.assert_allclose(_mat(q_t), _mat(q_j), atol=ATOL)
    # the same pivot branch: equal quaternions, not only equal rotations
    np.testing.assert_allclose(q_t, q_j, atol=1e-6)


def test_quaternion_algebra_matches():
    rng = np.random.RandomState(3)
    a = rng.randn(32, 4).astype(np.float32)
    b = rng.randn(32, 4).astype(np.float32)
    v = rng.randn(32, 3).astype(np.float32)
    an, bn = _j(jgeo.quat_normalize, a), _j(jgeo.quat_normalize, b)
    np.testing.assert_allclose(_t(tgeo.quat_normalize, a), an, atol=ATOL)
    np.testing.assert_allclose(_t(tgeo.quat_mul, an, bn), _j(jgeo.quat_mul, an, bn), atol=ATOL)
    np.testing.assert_allclose(_t(tgeo.quat_conj, an), _j(jgeo.quat_conj, an), atol=0)
    np.testing.assert_allclose(_t(tgeo.quat_rotate, an, v), _j(jgeo.quat_rotate, an, v), atol=1e-5)
    np.testing.assert_allclose(_t(tgeo.quat_to_mat, an), _mat(an), atol=ATOL)
    dw = 0.3 * rng.randn(32, 3).astype(np.float32)
    dw[:4] *= 1e-6  # the small-angle branch
    np.testing.assert_allclose(
        _mat(_t(tgeo.quat_exp_tangent, an, dw)), _mat(_j(jgeo.quat_exp_tangent, an, dw)), atol=ATOL
    )
    np.testing.assert_array_equal(tgeo.quat_identity((2,)).numpy(), np.asarray(jgeo.quat_identity((2,))))


def test_hat_vee_match():
    w = _axis_angles(4)
    np.testing.assert_array_equal(_t(tgeo.hat, w), _j(jgeo.hat, w))
    np.testing.assert_array_equal(_t(tgeo.vee, _j(jgeo.hat, w)), w)


def test_random_rotation_is_a_rotation():
    """Its draws come from a torch.Generator and differ from jax.random's;
    what must hold is that they are rotations."""
    R = tgeo.random_rotation(torch.Generator().manual_seed(0), (16,)).numpy()
    np.testing.assert_allclose(R @ np.swapaxes(R, 1, 2), np.broadcast_to(np.eye(3), R.shape), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)


@pytest.mark.parametrize("seed", [5, 6])
def test_pose_functions_match(seed):
    rng = np.random.RandomState(seed)
    Ra = _j(jgeo.so3_exp, _axis_angles(seed, 16))
    Rb = _j(jgeo.so3_exp, _axis_angles(seed + 10, 16))
    ca = rng.randn(16, 3).astype(np.float32)
    cb = rng.randn(16, 3).astype(np.float32)
    x = rng.randn(16, 3).astype(np.float32)
    ja, jb = jgeo.pose_from_Rc(jnp.asarray(Ra), jnp.asarray(ca)), jgeo.pose_from_Rc(jnp.asarray(Rb), jnp.asarray(cb))
    ta = tgeo.pose_from_Rc(torch.from_numpy(Ra), torch.from_numpy(ca))
    tb = tgeo.pose_from_Rc(torch.from_numpy(Rb), torch.from_numpy(cb))
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(tgeo.transform(ta, xt).numpy(), np.asarray(jgeo.transform(ja, x)), atol=1e-5)
    np.testing.assert_allclose(
        tgeo.inverse_transform(ta, xt).numpy(), np.asarray(jgeo.inverse_transform(ja, x)), atol=1e-5
    )
    for tp, jp in (
        (tgeo.compose(ta, tb), jgeo.compose(ja, jb)),
        (tgeo.pose_inverse(ta), jgeo.pose_inverse(ja)),
        (tgeo.relative_pose(ta, tb), jgeo.relative_pose(ja, jb)),
    ):
        np.testing.assert_allclose(_mat(tp.q.numpy()), _mat(np.asarray(jp.q)), atol=ATOL)
        np.testing.assert_allclose(tp.c.numpy(), np.asarray(jp.c), atol=1e-5)
    t = ta.t
    np.testing.assert_allclose(t.numpy(), np.asarray(ja.t), atol=1e-5)
    back = tgeo.pose_from_Rt(torch.from_numpy(Ra), t)
    np.testing.assert_allclose(back.c.numpy(), ca, atol=1e-5)
    K = np.array([[800.0, 0, 320], [0, 800, 240], [0, 0, 1]], np.float32)
    np.testing.assert_allclose(
        tgeo.projection_matrix(torch.from_numpy(K), ta).numpy(),
        np.asarray(jgeo.projection_matrix(jnp.asarray(K), ja)),
        rtol=1e-5, atol=1e-3,
    )
    ident = tgeo.pose_identity((3,))
    np.testing.assert_array_equal(ident.q.numpy(), np.asarray(jgeo.pose_identity((3,)).q))
