"""The port's epipolar solvers and robust estimation against the JAX
reference, on the CPU.

The same numpy inputs (two pinhole views of random points, outliers and
noise, all drawn with numpy) go through `alicevision_tpu` — each function
jitted, so that it compiles once — and through `alicevision_tpu_torch`
with CPU tensors. The two libraries' random streams
differ, so the port is handed the reference's minimal-sample indices.
Eigen- and singular vectors carry a sign that differs between libraries:
models are compared up to sign (F is Frobenius-normalized, H divided by
H[2, 2], so the scale is fixed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu import multiview as jmv
from alicevision_tpu import numeric as jnum
from alicevision_tpu import robust as jrb
from alicevision_tpu_torch import multiview as tmv
from alicevision_tpu_torch import numeric as tnum
from alicevision_tpu_torch import robust as trb

torch.set_num_threads(1)

IM = (1920.0, 1080.0)
F_PX, PP = 1200.0, np.array([960.0, 540.0])

# the JAX reference, jitted
j_f8 = jax.jit(jmv.fundamental_8pt)
j_f7 = jax.jit(jmv.fundamental_7pt)
j_f10 = jax.jit(jmv.fundamental_10pt, static_argnames=("n_lambda", "refine_rounds"))
j_e8 = jax.jit(jmv.essential_8pt)
j_pose = jax.jit(jmv.relative_pose_from_essential)
j_h4 = jax.jit(jmv.homography_4pt)
j_dist = jax.jit(jmv.epipolar_distance_sq)
j_herr = jax.jit(jmv.homography_error_sq)
j_sample = jax.jit(jrb.sample_minimal, static_argnums=(1, 2, 3))
j_acransac = jax.jit(jrb.acransac_select, static_argnames=("sample_size", "logalpha0", "mult_error",
                                                            "max_threshold_sq"))
j_rf = jax.jit(jrb.robust_fundamental, static_argnames=("im_size", "n_hyps", "max_error_px"))
j_rh = jax.jit(jrb.robust_homography, static_argnames=("im_size", "n_hyps", "max_error_px"))


def two_views(n, seed=0):
    """Pixels of n random points of a 6-unit cube in two pinhole views
    (f 1200 px, 1920x1080) 10 units from its centre, 0.6 rad apart around
    it; noise-free."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(-3.0, 3.0, (n, 3))

    def project(a):
        R = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])
        c = -10.0 * R[2]  # on the circle, looking at the origin
        xc = (X - c) @ R.T
        return (F_PX * xc[:, :2] / xc[:, 2:] + PP).astype(np.float32)

    return project(0.0), project(0.6)


def t(x, dtype=None):
    a = np.asarray(x)
    return torch.from_numpy(a.astype(dtype) if dtype else a.copy())


def np_(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_up_to_sign(a, b, rtol=1e-4, atol=1e-5):
    """Each (..., 3, 3) model of a equals + or - the one of b."""
    a, b = np_(a), np_(b)
    sign = np.sign(np.sum(a * b, axis=(-2, -1), keepdims=True))
    np.testing.assert_allclose(a, sign * b, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def pair():
    """Two noise-free views' correspondences, and the
    second view's with 0.3 px noise and 30 % outliers, and the outlier mask
    (noise-free residuals would put the a-contrario threshold at float32
    rounding)."""
    x1, x2 = two_views(160)
    rng = np.random.RandomState(0)
    out = rng.rand(len(x1)) < 0.3
    noisy = x2 + 0.3 * rng.randn(*x2.shape)
    x2c = np.where(out[:, None], rng.uniform(0, 1000, x2.shape), noisy).astype(np.float32)
    return x1, x2, x2c, out


def test_cubic_roots_and_log10_choose():
    rng = np.random.RandomState(1)
    c = rng.randn(4, 64).astype(np.float32)
    r_j, n_j = jnum.cubic_roots_real(*map(jnp.asarray, c))
    r_t, n_t = tnum.cubic_roots_real(*map(t, c))
    np.testing.assert_array_equal(np_(n_t), np.asarray(n_j))
    np.testing.assert_allclose(np_(r_t), np.asarray(r_j), rtol=1e-4, atol=1e-4)
    n = np.arange(10, 200, 7).astype(np.float32)
    k = np.full_like(n, 8.0)
    np.testing.assert_allclose(
        np_(trb.log10_choose(t(n), t(k))), np.asarray(jrb.log10_choose(n, k)), rtol=1e-5, atol=1e-4
    )


def test_normalize_points(pair):
    x1, _, _, out = pair
    for mask in (None, ~out):
        xn_j, T_j = jmv.normalize_points(jnp.asarray(x1), None if mask is None else jnp.asarray(mask))
        xn_t, T_t = tmv.normalize_points(t(x1), None if mask is None else t(mask))
        np.testing.assert_allclose(np_(xn_t), np.asarray(xn_j), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np_(T_t), np.asarray(T_j), rtol=1e-5, atol=1e-7)


def _samples(n, s, h, seed):
    rng = np.random.RandomState(seed)
    return np.stack([rng.choice(n, s, replace=False) for _ in range(h)])


def test_fundamental_solvers(pair):
    x1, x2, _, _ = pair
    # Over-determined hypotheses (12 points) are well conditioned, and the
    # two packages agree to float32 rounding; on exactly 8 points the null
    # vector of eigh(AᵀA) moves with the condition number of A in both
    # libraries, so minimal samples are compared where cond(A) < 100.
    idx = _samples(len(x1), 12, 32, 2)
    a, b = x1[idx], x2[idx]
    assert_up_to_sign(tmv.fundamental_8pt(t(a), t(b)), j_f8(jnp.asarray(a), jnp.asarray(b)))
    idx8 = _samples(len(x1), 8, 32, 2)
    A = tmv.epipolar._epipolar_design(*[tmv.normalize_points(t(v[idx8]))[0] for v in (x1, x2)]).numpy()
    good = np.linalg.cond(A.astype(np.float64)) < 100
    assert good.sum() >= 16
    a, b = x1[idx8][good], x2[idx8][good]
    assert_up_to_sign(tmv.fundamental_8pt(t(a), t(b)), j_f8(jnp.asarray(a), jnp.asarray(b)))
    F_t = tmv.fundamental_8pt(t(x1), t(x2))
    F_j = j_f8(jnp.asarray(x1), jnp.asarray(x2))
    assert_up_to_sign(F_t, F_j)
    m = np.arange(len(x1)) % 3 != 0
    assert_up_to_sign(
        tmv.fundamental_8pt(t(x1), t(x2), mask=t(m)),
        j_f8(jnp.asarray(x1), jnp.asarray(x2), mask=jnp.asarray(m)),
    )
    # residuals of the same models in both packages
    d_t = tmv.epipolar_distance_sq(F_t, t(x1), t(x2))
    d_j = j_dist(jnp.asarray(np_(F_t)), jnp.asarray(x1), jnp.asarray(x2))
    np.testing.assert_allclose(np_(d_t), np.asarray(d_j), rtol=1e-4, atol=1e-3)

    # 7 points span a two-dimensional null space, whose basis each eigh
    # picks its own way: the up-to-three solutions are the same set, in
    # another order. The closed-form cubic amplifies the null vectors'
    # float32 rounding where two roots lie close, so these agree to 5e-4.
    idx7 = _samples(len(x1), 7, 32, 3)
    F7_t = np_(tmv.fundamental_7pt(t(x1[idx7]), t(x2[idx7])))
    F7_j = np.asarray(j_f7(jnp.asarray(x1[idx7]), jnp.asarray(x2[idx7])))
    assert F7_t.shape == (32, 3, 3, 3)
    A = tmv.epipolar._epipolar_design(*[tmv.normalize_points(t(v[idx7]))[0] for v in (x1, x2)]).numpy()
    good = np.nonzero(np.linalg.cond(A.astype(np.float64)) < 100)[0]
    assert len(good) >= 16
    for h in good:
        for f in F7_t[h]:
            assert min(min(np.abs(f - g).max(), np.abs(f + g).max()) for g in F7_j[h]) < 5e-4


def test_fundamental_10pt(pair):
    x1, x2, _, _ = pair
    c = np.array([960.0, 540.0], np.float32)
    F_t, lam_t = tmv.fundamental_10pt(t(x1[:40] - c), t(x2[:40] - c), n_lambda=9, refine_rounds=2)
    F_j, lam_j = j_f10(jnp.asarray(x1[:40] - c), jnp.asarray(x2[:40] - c), n_lambda=9, refine_rounds=2)
    np.testing.assert_allclose(float(lam_t), float(lam_j), atol=1e-5)
    # the λ grids of torch.linspace and jnp.linspace differ in the last
    # bit, and F moves with λ
    assert_up_to_sign(F_t, F_j, rtol=1e-3, atol=5e-4)


def test_essential_and_relative_pose():
    x1, x2 = ((x - PP) / F_PX for x in two_views(100, seed=3))  # normalized camera coordinates
    E_t = tmv.essential_8pt(t(x1), t(x2))
    E_j = j_e8(jnp.asarray(x1), jnp.asarray(x2))
    assert_up_to_sign(E_t, E_j, rtol=1e-3, atol=1e-5)
    p_t = tmv.relative_pose_from_essential(E_t, t(x1), t(x2))
    p_j = j_pose(jnp.asarray(np_(E_t)), jnp.asarray(x1), jnp.asarray(x2))
    np.testing.assert_allclose(np_(p_t.R), np.asarray(p_j.R), atol=1e-4)
    np.testing.assert_allclose(np_(p_t.c), np.asarray(p_j.c), atol=1e-4)
    R_t, t_t, n_t = tmv.select_cheirality(*tmv.decompose_essential(E_t), t(x1), t(x2))
    assert int(n_t) == len(x1)


def test_homography(pair):
    rng = np.random.RandomState(4)
    Hgt = np.array([[1.1, 0.05, 20.0], [-0.03, 0.95, -10.0], [1e-4, -5e-5, 1.0]])
    x1 = rng.uniform(0, 1000, (80, 2)).astype(np.float32)
    p = np.concatenate([x1, np.ones((80, 1), np.float32)], 1) @ Hgt.T
    x2 = (p[:, :2] / p[:, 2:]).astype(np.float32)
    # six points a hypothesis: over-determined, so the null vector is well
    # conditioned (on four, it moves with cond(A) in both libraries)
    idx = _samples(80, 6, 16, 5)
    H_t = tmv.homography_4pt(t(x1[idx]), t(x2[idx]))
    H_j = j_h4(jnp.asarray(x1[idx]), jnp.asarray(x2[idx]))
    np.testing.assert_allclose(np_(H_t), np.asarray(H_j), rtol=1e-3, atol=1e-5)
    e_t = tmv.homography_error_sq(H_t, t(x1)[None], t(x2)[None])
    e_j = j_herr(jnp.asarray(np_(H_t)), jnp.asarray(x1)[None], jnp.asarray(x2)[None])
    np.testing.assert_allclose(np_(e_t), np.asarray(e_j), rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def residuals(pair):
    """JAX's hypotheses and residual matrix for the corrupted pair."""
    x1, _, x2c, out = pair
    valid = np.arange(len(x1)) < 150  # padding at the tail
    idx = np.asarray(j_sample(jax.random.PRNGKey(6), len(x1), 8, 128, jnp.asarray(valid)))
    F = j_f8(jnp.asarray(x1[idx]), jnp.asarray(x2c[idx]))
    res = np.asarray(j_dist(F, jnp.asarray(x1)[None], jnp.asarray(x2c)[None]))
    return res, valid


def test_acransac_select(residuals):
    res, valid = residuals
    kw = dict(sample_size=8, logalpha0=jrb.logalpha0_line(*IM), mult_error=0.5, max_threshold_sq=16.0)
    s_j = j_acransac(jnp.asarray(res), valid=jnp.asarray(valid), **kw)
    s_t = trb.acransac_select(t(res), valid=t(valid), **kw)
    assert int(s_t.best_hyp) == int(s_j.best_hyp)
    np.testing.assert_array_equal(np_(s_t.inliers), np.asarray(s_j.inliers))
    np.testing.assert_allclose(float(s_t.threshold_sq), float(s_j.threshold_sq), rtol=1e-5)
    np.testing.assert_allclose(float(s_t.best_nfa), float(s_j.best_nfa), rtol=1e-4)
    assert int(s_t.n_inliers) == int(s_j.n_inliers)
    # batched: two copies of the problem in one call give the same answer twice
    s_b = trb.acransac_select(t(np.stack([res, res])), valid=t(np.stack([valid, valid])), **kw)
    assert np_(s_b.best_hyp).tolist() == [int(s_j.best_hyp)] * 2


def test_simple_and_lmeds_select(residuals):
    res, valid = residuals
    a_j = jrb.simple_select(jnp.asarray(res), 4.0, jnp.asarray(valid))
    a_t = trb.simple_select(t(res), 4.0, t(valid))
    assert int(a_t.best_hyp) == int(a_j.best_hyp)
    np.testing.assert_array_equal(np_(a_t.inliers), np.asarray(a_j.inliers))
    b_j = jrb.lmeds_select(jnp.asarray(res), 8, jnp.asarray(valid))
    b_t = trb.lmeds_select(t(res), 8, t(valid))
    assert int(b_t.best_hyp) == int(b_j.best_hyp)
    np.testing.assert_allclose(float(b_t.threshold_sq), float(b_j.threshold_sq), rtol=1e-5)
    np.testing.assert_array_equal(np_(b_t.inliers), np.asarray(b_j.inliers))


def test_sample_minimal_properties():
    g = torch.Generator().manual_seed(0)
    idx = trb.sample_minimal(g, 50, 8, 64)
    assert idx.shape == (64, 8)
    assert all(len(set(r.tolist())) == 8 for r in idx)
    valid = torch.arange(50) < 10
    idx = trb.sample_minimal(g, 50, 3, 32, torch.stack([valid, valid]))
    assert idx.shape == (2, 32, 3) and int(idx.max()) < 10


def _agreement(a, b):
    a, b = np_(a), np.asarray(b)
    return (a == b).mean()


def test_robust_fundamental_with_reference_samples(pair):
    x1, x2, x2c, out = pair
    key = jax.random.PRNGKey(7)
    rm_j = j_rf(key, jnp.asarray(x1), jnp.asarray(x2c), IM, n_hyps=256)
    idx = np.asarray(j_sample(key, len(x1), 8, 256, None))
    rm_t = trb.robust_fundamental(None, t(x1), t(x2c), IM, n_hyps=256, idx=t(idx))
    assert _agreement(rm_t.inliers, rm_j.inliers) >= 0.99
    assert (np_(rm_t.inliers) & out).sum() <= 3
    # drawn from a generator instead: still the true inliers
    rm_g = trb.robust_fundamental(torch.Generator().manual_seed(1), t(x1), t(x2c), IM, n_hyps=256)
    inl = np_(rm_g.inliers)
    assert (inl & out).sum() <= 3 and inl.sum() > 0.8 * (~out).sum()


def test_robust_fundamental_batch_with_reference_samples(pair):
    x1, x2, x2c, out = pair
    B, n = 3, len(x1)
    X1 = np.stack([x1, x1, x2c])
    X2 = np.stack([x2c, x2c[::-1], x1])
    valid = np.stack([np.arange(n) < n - 10 * b for b in range(B)])
    keys = jax.random.split(jax.random.PRNGKey(8), B)
    rm_j = jrb.robust_fundamental_batch(keys, jnp.asarray(X1), jnp.asarray(X2), IM, jnp.asarray(valid), n_hyps=128)
    idx = np.asarray(jax.vmap(lambda k, v: jrb.sample_minimal(k, n, 8, 128, v))(keys, jnp.asarray(valid)))
    rm_t = trb.robust_fundamental_batch(None, t(X1), t(X2), IM, t(valid), n_hyps=128, idx=t(idx))
    assert rm_t.inliers.shape == (B, n)
    for b in range(B):
        assert _agreement(rm_t.inliers[b], np.asarray(rm_j.inliers)[b]) >= 0.99
    assert_up_to_sign(rm_t.model[1:], rm_j.model[1:], rtol=1e-2, atol=1e-4)


def test_robust_homography_with_reference_samples():
    rng = np.random.RandomState(9)
    Hgt = np.array([[1.05, 0.02, 15.0], [-0.01, 0.97, -8.0], [5e-5, -2e-5, 1.0]])
    x1 = rng.uniform(0, 1000, (120, 2)).astype(np.float32)
    p = np.concatenate([x1, np.ones((120, 1), np.float32)], 1) @ Hgt.T
    x2 = (p[:, :2] / p[:, 2:] + 0.3 * rng.randn(120, 2)).astype(np.float32)
    out = rng.rand(120) < 0.25
    x2[out] = rng.uniform(0, 1000, (out.sum(), 2))
    key = jax.random.PRNGKey(10)
    rm_j = j_rh(key, jnp.asarray(x1), jnp.asarray(x2), IM, n_hyps=128)
    idx = np.asarray(j_sample(key, 120, 4, 128, None))
    rm_t = trb.robust_homography(None, t(x1), t(x2), IM, n_hyps=128, idx=t(idx))
    assert _agreement(rm_t.inliers, rm_j.inliers) >= 0.99
    np.testing.assert_allclose(np_(rm_t.model), np.asarray(rm_j.model), rtol=1e-2, atol=1e-4)
