"""The port's K-VLD and photometric (patch ZNCC) match filters against the
JAX package's, on the CPU, on tests/test_intrinsics_refine_kvld.py's inputs
(numpy from a seed: a blurred noise image and its shifted copy, true
matches beside random ones).

Tolerances: the keep masks equal; the ZNCC scores within atol 1e-5; the
virtual-line (gvld) scores of the admissible pairs within atol 1e-5 (their
histograms are one-hot sums in the port, scatter-adds in JAX: the float32
sums differ in the last bits).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from alicevision_tpu.image.filtering import gaussian_blur
from alicevision_tpu.matching import kvld as jkvld
from alicevision_tpu_torch.matching import kvld as tkvld

# the packages' `matching.photometric_filter` attribute is the function
jpf = importlib.import_module("alicevision_tpu.matching.photometric_filter")
tpf = importlib.import_module("alicevision_tpu_torch.matching.photometric_filter")

torch.set_num_threads(1)

ZNCC_ATOL = 1e-5
GVLD_ATOL = 1e-5


def _photometric_inputs(seed=0, n=40):
    rng = np.random.RandomState(seed)
    img1 = ndi.gaussian_filter(rng.rand(128, 128).astype(np.float32), 1.0)
    img2 = np.roll(img1, 5, axis=1)  # true correspondence: x2 = x1 + 5
    xy1 = rng.uniform(20, 108, (n, 2))
    good = np.stack([xy1[:, 0] + 5, xy1[:, 1]], -1)
    bad = rng.uniform(20, 108, (n, 2))
    is_good = rng.rand(n) < 0.5
    xy2 = np.where(is_good[:, None], good, bad)
    feats1 = {"xy": xy1, "scale": np.full(n, 2.0), "orientation": rng.uniform(-0.3, 0.3, n)}
    feats2 = {"xy": xy2, "scale": np.full(n, 2.0), "orientation": feats1["orientation"].copy()}
    pairs = np.stack([np.arange(n), np.arange(n)], -1)
    return img1, img2, feats1, feats2, pairs, is_good


def _kvld_inputs(seed=0, n_in=40, n_out=20):
    rng = np.random.RandomState(seed)
    H, W, S = 160, 200, 12
    base = np.asarray(gaussian_blur(jnp.asarray(rng.rand(H, W + S).astype(np.float32)), 2.0))
    img1, img2 = base[:, :W], base[:, S:]
    p1 = np.stack([rng.uniform(25, W - 25, n_in), rng.uniform(25, H - 25, n_in)], 1)
    p2 = p1 - np.array([S, 0.0])  # true correspondence
    o1 = np.stack([rng.uniform(25, W - 25, n_out), rng.uniform(25, H - 25, n_out)], 1)
    o2 = np.stack([rng.uniform(25, W - 25, n_out), rng.uniform(25, H - 25, n_out)], 1)
    return img1, img2, np.concatenate([p1, o1]), np.concatenate([p2, o2])


@pytest.mark.parametrize("min_zncc", [0.3, 0.5])
def test_photometric_filter_matches(min_zncc):
    img1, img2, f1, f2, pairs, is_good = _photometric_inputs()
    kj, sj = jpf.photometric_filter(img1, img2, f1, f2, pairs, min_zncc=min_zncc)
    kt, st = tpf.photometric_filter(img1, img2, f1, f2, pairs, min_zncc=min_zncc, device="cpu")
    np.testing.assert_allclose(st, sj, atol=ZNCC_ATOL)
    np.testing.assert_array_equal(kt, kj)
    kept = np.zeros(len(pairs), bool)
    kept[kt[:, 0]] = True
    assert kept[is_good].mean() > 0.85 and kept[~is_good].mean() < 0.25
    empty, es = tpf.photometric_filter(img1, img2, f1, f2, pairs[:0], device="cpu")
    assert empty.shape == (0, 2) and es.shape == (0,)


def test_patch_zncc_scores_single_image_form():
    """`_gather_rotated_patch`'s single-image form (the JAX package's) is
    its stack form on a one-image stack; ZNCC of a patch with itself is 1."""
    from alicevision_tpu.features.sift import _gather_rotated_patch as jpatch
    from alicevision_tpu_torch.features.sift import _gather_rotated_patch as tpatch

    img1, _, f1, _, _, _ = _photometric_inputs(seed=1)
    t = torch.from_numpy(img1)
    xy, o = f1["xy"][:8].astype(np.float32), f1["orientation"][:8].astype(np.float32)
    got = tpatch(t, torch.from_numpy(xy[:, 0]), torch.from_numpy(xy[:, 1]), 1.5, torch.from_numpy(o), 12)
    want = jax.vmap(lambda c, a: jpatch(jnp.asarray(img1), c[0], c[1], 1.5, a, 12))(jnp.asarray(xy), jnp.asarray(o))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    one = torch.ones(8)
    s = tpf.patch_zncc_scores(t, t, torch.from_numpy(xy), torch.from_numpy(xy), 2 * one, 2 * one,
                              torch.from_numpy(o), torch.from_numpy(o))
    np.testing.assert_allclose(s.numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_kvld_filter_matches(seed):
    img1, img2, xy1, xy2 = _kvld_inputs(seed)
    kj = jkvld.kvld_filter(img1, img2, xy1, xy2)
    kt = tkvld.kvld_filter(img1, img2, xy1, xy2, device="cpu")
    np.testing.assert_array_equal(kt, kj)
    assert kt[:40].mean() > 0.8 and kt[40:].mean() < 0.3


def test_kvld_pair_scores_match():
    """The gvld score of every admissible neighbour pair of seed 0."""
    img1, img2, xy1, xy2 = (np.asarray(a, np.float32) for a in _kvld_inputs(0))
    M, k = len(xy1), 10
    d = np.linalg.norm(xy1[:, None] - xy1[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    ii = np.repeat(np.arange(M), k)
    jj = np.argpartition(d, k - 1, axis=1)[:, :k].reshape(-1)
    want = np.asarray(jax.jit(jax.vmap(lambda a1, b1, a2, b2: jkvld._pair_score(
        jnp.asarray(img1), jnp.asarray(img2), a1, b1, a2, b2)))(xy1[ii], xy1[jj], xy2[ii], xy2[jj]))
    t = torch.from_numpy
    got = tkvld._pair_score(t(img1), t(img2), t(xy1[ii]), t(xy1[jj]), t(xy2[ii]), t(xy2[jj])).numpy()
    np.testing.assert_allclose(got, want, atol=GVLD_ATOL)
    # too few matches to support any: everything kept, as in JAX
    np.testing.assert_array_equal(tkvld.kvld_filter(img1, img2, xy1[:2], xy2[:2], device="cpu"),
                                  jkvld.kvld_filter(img1, img2, xy1[:2], xy2[:2]))
