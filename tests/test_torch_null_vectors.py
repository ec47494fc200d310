"""The null-vector solvers' float64 route on a card (`numeric.normal_eigh`:
the 5-point null space, the 8-point F and the 4-point H) against the JAX
functions on the CPU, on the samples where float32 loses.

An H100's batched float32 eigh solved fewer of chip_smoke.py's hard-scene
samples than the CPU's LAPACK (`solvers` step: F 0.598 against 0.841, H
0.760 against 0.880, the 5-point agreeing with the CPU on 0.960), so a card
forms and decomposes AᵀA in float64 (`numeric._normal_eigh64`); the CPU keeps
LAPACK's float32, as the JAX package computes. Here the solvers take the
card's route on the CPU (their `normal_eigh` patched to `_normal_eigh64`)
on `chip_smoke.eigh_site_samples`. On the
samples where the JAX function in float32 misses the truth (beyond
`chip_smoke.EIGH_SITE_TOL`), the route is held to the JAX function
evaluated in float64 (`jax.enable_x64`, scoped, on the same float32
inputs): of the samples that solves, the route solves at least 90 % (the
5-point's polynomial and polish stay float32), and there agrees with it
within 1e-4 (unit E), 1e-3 (unit F: its rank-2 SVD stays float32) and
1e-2 px (H's transfer of a fifth plane point).
Elsewhere the CPU's route equals the JAX function's float32 result as
before (tests/test_torch_robust*.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from alicevision_tpu import multiview as jmv
from alicevision_tpu_torch import multiview as mv
from alicevision_tpu_torch import numeric
from alicevision_tpu_torch.multiview import epipolar, five_point

torch.set_num_threads(1)

N = 512
# the route against JAX in float64: unit E and F entries; H's transfer of a
# fifth plane point, px
AGREE = {"essential_5pt": 1e-4, "fundamental_8pt": 1e-3, "homography_4pt": 1e-2}


@pytest.fixture(scope="module")
def samples():
    return chip_smoke.eigh_site_samples(N)


def _unit(M, ref):
    M = np.array(M, np.float64).reshape(len(ref), -1)
    M = M / np.linalg.norm(M, axis=-1, keepdims=True)
    return M * np.where((M * ref).sum(-1, keepdims=True) < 0, -1.0, 1.0)


def _f_err(F, f):
    return np.linalg.norm(_unit(F, f) - f, axis=-1)


def _site(name, smp):
    """(float32 inputs, the JAX function, the port's function, the truth
    (unit rows), error of a result against the truth, the result compared)."""
    if name == "fundamental_8pt":
        f = smp["F"].reshape(N, 9)
        f = f / np.linalg.norm(f, axis=-1, keepdims=True)
        return ((smp["px1"], smp["px2"]), jmv.fundamental_8pt, mv.fundamental_8pt,
                lambda F: _f_err(F, f), lambda F: _unit(F, f))
    if name == "homography_4pt":
        p5 = np.append(smp["plane1"][:, 4], np.ones((N, 1)), -1)

        def transfer(H):  # the fifth plane point through H
            q = np.einsum("nij,nj->ni", np.asarray(H, np.float64), p5)
            return q[:, :2] / q[:, 2:]

        return ((smp["plane1"][:, :4], smp["plane2"][:, :4]), jmv.homography_4pt, mv.homography_4pt,
                lambda H: np.linalg.norm(transfer(H) - smp["plane2"][:, 4], axis=-1), transfer)
    e = smp["E"].reshape(N, 9)
    e = e / np.linalg.norm(e, axis=-1, keepdims=True)

    def best(out):
        E, ok = (np.asarray(x) for x in out)
        cand = _unit(E.reshape(-1, 9), np.repeat(e, E.shape[1], 0)).reshape(N, -1, 9)
        d = np.where(ok, np.linalg.norm(cand - e[:, None], axis=-1), np.inf)
        return d.min(-1), cand[np.arange(N), d.argmin(-1)]

    return ((smp["x1n"][:, :5], smp["x2n"][:, :5]), jmv.essential_5pt, mv.essential_5pt,
            lambda out: best(out)[0], lambda out: best(out)[1])


@pytest.mark.parametrize("name", ["essential_5pt", "fundamental_8pt", "homography_4pt"])
def test_float64_route_matches_jax_float64_where_float32_loses(samples, name, monkeypatch):
    (a, b), jfn, fn, err, value = _site(name, samples)
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    j32 = jax.jit(jax.vmap(jfn))(jnp.asarray(a32), jnp.asarray(b32))
    with jax.enable_x64(True):
        j64 = jax.jit(jax.vmap(jfn))(jnp.asarray(a32, jnp.float64), jnp.asarray(b32, jnp.float64))
        j64 = jax.tree_util.tree_map(np.asarray, j64)
    for module in (epipolar, five_point):
        monkeypatch.setattr(module, "normal_eigh", numeric._normal_eigh64)
    got = fn(torch.as_tensor(a32), torch.as_tensor(b32))
    got = jax.tree_util.tree_map(lambda x: x.numpy(), got) if isinstance(got, tuple) else got.numpy()
    tol = chip_smoke.EIGH_SITE_TOL[name]
    lose = err(j32) > tol
    assert lose.sum() >= 5, (name, lose.sum())  # the samples where float32 loses
    solved64 = err(j64)[lose] < tol
    assert solved64.mean() > 0.5, (name, solved64.mean())
    solved = err(got)[lose][solved64] < tol
    assert solved.mean() >= 0.9, (name, solved.mean())
    v, v64 = value(got)[lose][solved64][solved], value(j64)[lose][solved64][solved]
    assert np.abs(v - v64).max() < AGREE[name], (name, np.abs(v - v64).max())
