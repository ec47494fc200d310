"""The port's resection solvers (`multiview/resection.py`: `kabsch`, `p3p`,
`gauss_newton_pose_refine`) against the JAX reference on the CPU.

Poses and points are drawn with numpy; both packages get the same float32
inputs (JAX's functions jitted). P3P returns up to 4 candidates a sample in
slots that depend on the quartic's float32 roots, so its valid (R, t) are
compared as sets (atol 1e-3), and nearly every set holds the true pose; the
interpolated quartic's coefficients are held to JAX's at rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu import multiview as jmv
from alicevision_tpu.geometry.rotations import so3_exp as j_so3_exp
from alicevision_tpu_torch import multiview as tmv

torch.set_num_threads(1)

j_kabsch = jax.jit(jmv.kabsch)
j_p3p = jax.jit(jmv.p3p)
j_gn = jax.jit(jmv.gauss_newton_pose_refine, static_argnames=("iters",))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rotations(rng, n, scale=1.0):
    return np.asarray(jax.vmap(j_so3_exp)(jnp.asarray(rng.randn(n, 3) * scale, jnp.float32)))


@pytest.fixture(scope="module")
def poses():
    """16 poses looking down +z at points 4-8 units away, their world
    points (16, 20, 3) and normalized observations."""
    rng = np.random.RandomState(0)
    R = _rotations(rng, 16, 0.4)
    tt = np.c_[rng.randn(16, 2) * 0.3, rng.uniform(5, 7, 16)].astype(np.float32)
    Xc = np.c_[rng.uniform(-2, 2, (16 * 20, 2)), rng.uniform(-1, 1, 16 * 20)].reshape(16, 20, 3)
    Xc[..., 2] += tt[:, None, 2]
    world = np.einsum("bji,bnj->bni", R, Xc - tt[:, None, :]).astype(np.float32)
    obs = (Xc[..., :2] / Xc[..., 2:]).astype(np.float32)
    return R, tt, world, obs


def test_kabsch(poses):
    R, tt, world, _ = poses
    dst = (np.einsum("bij,bnj->bni", R, world) + tt[:, None]).astype(np.float32)
    mask = np.arange(20) % 4 != 0
    for m in (None, np.broadcast_to(mask, (16, 20))):
        R_t, t_t = tmv.kabsch(t(world), t(dst), None if m is None else t(m))
        R_j, t_j = j_kabsch(world, dst, m)
        np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-5)
        np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-4)
        np.testing.assert_allclose(R_t.numpy(), R, atol=1e-4)


def test_p3p_as_sets(poses):
    R, tt, world, obs = poses
    w3 = world[:, :3]
    rays = np.c_[obs[:, :3].reshape(-1, 2), np.ones(48)].reshape(16, 3, 3)
    rays = (rays / np.linalg.norm(rays, axis=-1, keepdims=True)).astype(np.float32)
    R_t, t_t, v_t = (a.numpy() for a in tmv.p3p(t(w3), t(rays)))
    R_j, t_j, v_j = (np.asarray(a) for a in j_p3p(w3, rays))
    assert R_t.shape == (16, 4, 3, 3) and v_t.shape == (16, 4)

    def members(Rs, ts, valid):
        return [np.concatenate([r.ravel(), x]) for r, x, ok in zip(Rs, ts, valid) if ok]

    def has(p, ps):
        return any(np.abs(p - q).max() < 1e-3 for q in ps)

    found = 0
    for b in range(16):
        st, sj = members(R_t[b], t_t[b], v_t[b]), members(R_j[b], t_j[b], v_j[b])
        assert all(has(p, sj) for p in st) and all(has(p, st) for p in sj), b
        found += has(np.concatenate([R[b].ravel(), tt[b]]), st)
    # where the quartic's true root is double, float32 flags it complex in
    # both packages (sample 3 here)
    assert found >= 14, found


def test_p3p_quartic_coefficients():
    """The resultant's quartic interpolated from its 5 samples: the port's
    float64 Vandermonde inverse against JAX's float32 one, on random
    samples."""
    from alicevision_tpu_torch.multiview.resection import _TS, _VINV

    rng = np.random.RandomState(3)
    vals = rng.randn(64, 5).astype(np.float32)
    V = jnp.stack([jnp.asarray(_TS, jnp.float32) ** i for i in range(5)], axis=-1)
    c_j = np.asarray(jnp.einsum("ij,...j->...i", jnp.linalg.inv(V), vals))
    c_t = (t(vals) @ torch.as_tensor(_VINV.T, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(c_t, c_j, rtol=1e-4, atol=1e-5)


def test_gauss_newton_pose_refine(poses):
    R, tt, world, obs = poses
    rng = np.random.RandomState(4)
    R0 = np.einsum("bij,bjk->bik", _rotations(rng, 16, 0.02), R).astype(np.float32)
    t0 = (tt + 0.05 * rng.randn(16, 3)).astype(np.float32)
    noisy = (obs + 1e-3 * rng.randn(*obs.shape)).astype(np.float32)
    mask = rng.rand(16, 20) < 0.8
    for m in (None, mask):
        R_t, t_t = tmv.gauss_newton_pose_refine(t(R0), t(t0), t(world), t(noisy), None if m is None else t(m), iters=5)
        R_j, t_j = j_gn(R0, t0, world, noisy, m, iters=5)
        np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-5)
        np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-4)
        np.testing.assert_allclose(R_t.numpy(), R, atol=2e-2)  # 1e-3 noise on 20 points
