"""The port's 5-point solver (`multiview/five_point.py`) and Ferrari quartic
(`numeric.quartic_roots_real`) against the JAX reference on the CPU.
The quartic's roots are held at 1e-4 (98 % of them) and 2e-3 (all).

Inputs are drawn with numpy, or taken from the JAX package's synthetic ring
scene (`utils.synthetic.ring_scene`, noise-free, normalized coordinates)
carried over as numpy. The solver's candidate slots are not comparable one
by one: `torch.topk` may order tied sign-scan intervals differently from
`lax.top_k`, and slots that polish onto the same root duplicate. So the
*sets* of valid candidates are compared — roots as sorted sets, essential
matrices up to sign and scale (unit Frobenius norm) at 1e-3 — on
well-conditioned samples (5 correspondences spread over the image). The
true essential matrix is in both sets; spurious candidates near
ill-conditioned roots may differ (bounds in the test).
"""

import jax
import numpy as np
import pytest
import torch

from alicevision_tpu import multiview as jmv
from alicevision_tpu import numeric as jnum
from alicevision_tpu.multiview import five_point as jfp
from alicevision_tpu.utils.synthetic import normalized_obs, ring_scene
from alicevision_tpu_torch import multiview as tmv
from alicevision_tpu_torch import numeric as tnum
from alicevision_tpu_torch.multiview import five_point as tfp

torch.set_num_threads(1)

E_TOL = 1e-3

j_quartic = jax.jit(jnum.quartic_roots_real)
j_roots = jax.jit(jfp.real_roots_deg10)
j_e5 = jax.jit(jmv.essential_5pt)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_quartic_roots_real():
    rng = np.random.RandomState(0)
    c = rng.randn(5, 256).astype(np.float32)
    r_j, ok_j = (np.asarray(a) for a in j_quartic(*c))
    r_t, ok_t = (a.numpy() for a in tnum.quartic_roots_real(*map(t, c)))
    np.testing.assert_array_equal(ok_t, ok_j)
    # where the resolvent's root m is near 0, s = sqrt(2m) moves a
    # quadratic factor's pair by ~sqrt(float32 eps): 98 % of the roots
    # agree to 1e-4, every root to 2e-3
    diff = np.abs(r_t - r_j)[ok_j]
    assert (diff < 1e-4).mean() >= 0.98 and diff.max() < 2e-3, diff.max()
    # the valid roots are roots (relative to the coefficients' scale; the
    # ill-conditioned pairs above reach ~7e-3)
    vals = sum(c[4 - i][:, None] * r_t**i for i in range(5))
    scale = np.abs(c).max(0)[:, None] * np.maximum(1.0, np.abs(r_t)) ** 4
    assert (np.abs(vals / scale)[ok_t] < 1e-2).all()


def test_real_roots_deg10_as_sets():
    """Degree-10 polynomials built from 2-8 real roots (spread over
    [-3, 3], at least 0.2 apart) and complex pairs: the sorted valid roots
    of both packages equal the true ones."""
    rng = np.random.RandomState(1)
    polys, truth = [], []
    for i in range(32):
        n_real = 2 * (i % 4) + 2
        while True:
            r = np.sort(rng.uniform(-3, 3, n_real))
            if np.diff(r).min() > 0.2:
                break
        p = np.poly(r)
        for _ in range((10 - n_real) // 2):
            a, b = rng.uniform(-2, 2), rng.uniform(0.5, 2)
            p = np.polymul(p, [1.0, -2 * a, a * a + b * b])
        polys.append(p * rng.uniform(0.5, 2))
        truth.append(r)
    polys = np.array(polys, np.float32)
    r_j, v_j = (np.asarray(a) for a in j_roots(polys))
    r_t, v_t = (a.numpy() for a in tfp.real_roots_deg10(t(polys)))
    for i in range(len(polys)):
        st, sj = np.sort(r_t[i][v_t[i]]), np.sort(r_j[i][v_j[i]])
        assert len(st) == len(sj) == len(truth[i]), (i, st, sj, truth[i])
        # within ~1e-4 of a root the float32 polynomial's sign is noise,
        # and the bisections may end on either side
        np.testing.assert_allclose(st, sj, atol=1e-3)
        np.testing.assert_allclose(st, truth[i], atol=2e-3)


def _unique(Es):
    out = []
    for E in Es:
        if not any(min(np.abs(E - F).max(), np.abs(E + F).max()) < E_TOL for F in out):
            out.append(E)
    return out


def _in(E, Fs):
    return any(min(np.abs(E - F).max(), np.abs(E + F).max()) < E_TOL for F in Fs)


@pytest.fixture(scope="module")
def samples():
    """Well-conditioned 5-point samples between views 0 and 2 of the ring
    scene, and the true essential matrix (unit norm)."""
    scene = ring_scene(n_views=6, n_points=200, noise_px=0.0, seed=0)
    vis = np.asarray(scene.visible)
    xn = np.asarray(normalized_obs(scene))
    common = np.nonzero(vis[0] & vis[2])[0]
    rng = np.random.RandomState(2)
    idx = []
    while len(idx) < 24:
        s = rng.choice(common, 5, replace=False)
        a = xn[0, s]
        # spread: the 5 points span the image (no near-collinear samples)
        if np.linalg.svd(a - a.mean(0), compute_uv=False).min() > 0.05:
            idx.append(s)
    idx = np.array(idx)
    R = np.asarray(scene.poses.R)
    c = np.asarray(scene.poses.c)
    Rrel = R[2] @ R[0].T
    tr = R[2] @ (c[0] - c[2])
    E = np.array([[0, -tr[2], tr[1]], [tr[2], 0, -tr[0]], [-tr[1], tr[0], 0]]) @ Rrel
    return xn[0, idx].astype(np.float32), xn[2, idx].astype(np.float32), E / np.linalg.norm(E)


def test_essential_5pt_as_sets(samples):
    x1, x2, E_true = samples
    E_j, v_j = (np.asarray(a) for a in j_e5(x1, x2))
    E_t, v_t = (a.numpy() for a in tmv.essential_5pt(t(x1), t(x2)))
    assert E_t.shape == (len(x1), 24, 3, 3) and v_t.shape == (len(x1), 24)
    same = found = unmatched = total = 0
    for h in range(len(x1)):
        set_t, set_j = _unique(E_t[h][v_t[h]]), _unique(E_j[h][v_j[h]])
        # the port finds the true geometry wherever the reference does
        assert _in(E_true, set_t) or not _in(E_true, set_j), h
        found += _in(E_true, set_t)
        # every valid candidate satisfies the epipolar rows of its sample
        # (unit E; the reference's validity gate is 5e-4 on the constraints)
        for E in set_t:
            r = np.einsum("ni,ij,nj->n", np.c_[x2[h], np.ones(5)], E, np.c_[x1[h], np.ones(5)])
            assert np.abs(r).max() < 1e-3
        miss = sum(not _in(E, set_j) for E in set_t) + sum(not _in(E, set_t) for E in set_j)
        same += miss == 0
        unmatched += miss
        total += len(set_t) + len(set_j)
    # The true roots agree; a spurious candidate near an ill-conditioned
    # root (one that passes the 5e-4 constraint gate without solving the
    # system) appears in one package and not the other, or 1e-3-0.1 away:
    # on this sample set 6 of 24 samples hold one, 12 of ~120 candidates.
    assert same >= 0.7 * len(x1), same
    assert unmatched <= 0.15 * total, (unmatched, total)
    assert found >= 0.9 * len(x1), found
