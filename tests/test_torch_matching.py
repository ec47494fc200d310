"""The port's descriptor matching and vocabulary tree against the JAX
reference, on the CPU.

The same descriptor sets (`_desc_sets` of tests/test_matching_tracks.py,
drawn once with JAX and handed across as numpy) go through
`alicevision_tpu` and through `alicevision_tpu_torch` with CPU tensors.
Random parts are carried across, not redrawn: the cascade hash gets JAX's
projection, the vocabulary tree is JAX's tree (`convert.voctree_from_numpy`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_matching_tracks import _desc_sets

from alicevision_tpu.matching import descriptor_matching as jdm
from alicevision_tpu.matching import voctree as jvt
from alicevision_tpu_torch import convert
from alicevision_tpu_torch.matching import descriptor_matching as tdm
from alicevision_tpu_torch.matching import voctree as tvt

torch.set_num_threads(1)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def sets():
    d1, d2, perm = _desc_sets(jax.random.PRNGKey(0), n=200)
    e1, e2, _ = _desc_sets(jax.random.PRNGKey(1), n=150, noise=0.05)
    return np.asarray(d1), np.asarray(d2), np.asarray(e1), np.asarray(e2)


@pytest.mark.parametrize("cross_check", [True, False])
def test_match_bruteforce_identical(sets, cross_check):
    d1, d2, e1, e2 = sets
    v1 = np.arange(200) % 7 != 0
    v2 = np.arange(200) % 5 != 0
    for a, b, va, vb in ((d1, d2, v1, v2), (e1, e2, v1[:150], v2[:150])):
        m_j = jdm.match_bruteforce(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb),
                                   cross_check=cross_check)
        m_t = tdm.match_bruteforce(t(a), t(b), t(va), t(vb), cross_check=cross_check)
        np.testing.assert_array_equal(m_t.idx2.numpy(), np.asarray(m_j.idx2))
        np.testing.assert_allclose(m_t.dist.numpy(), np.asarray(m_j.dist), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(tdm.matches_to_pairs(m_t), jdm.matches_to_pairs(m_j))


def test_match_bruteforce_batched_and_hamming(sets):
    d1, d2, e1, e2 = sets
    v = np.ones(150, bool)
    A, B = np.stack([d1[:150], e1]), np.stack([d2[:150], e2])
    m_b = tdm.match_bruteforce(t(A), t(B), t(np.stack([v, v])), t(np.stack([v, v])))
    for g in range(2):
        m_j = jdm.match_bruteforce(jnp.asarray(A[g]), jnp.asarray(B[g]), jnp.asarray(v), jnp.asarray(v))
        np.testing.assert_array_equal(m_b.idx2[g].numpy(), np.asarray(m_j.idx2))
    bits1 = (d1[:100] > np.median(d1)).astype(np.float32)
    bits2 = bits1.copy()
    bits2[:, :5] = 1 - bits2[:, :5]
    m_j = jdm.match_bruteforce_hamming(*map(jnp.asarray, (bits1, bits2, v[:100], v[:100])))
    m_t = tdm.match_bruteforce_hamming(*map(t, (bits1, bits2, v[:100], v[:100])))
    np.testing.assert_array_equal(m_t.idx2.numpy(), np.asarray(m_j.idx2))


def test_match_ann_l2(sets):
    d1, d2, _, _ = sets
    v = np.arange(200) % 9 != 0
    m_j = jdm.match_ann_l2(d1, d2, v, v)
    m_t = tdm.match_ann_l2(t(d1), t(d2), t(v), t(v))
    np.testing.assert_array_equal(m_t.idx2.numpy(), np.asarray(m_j.idx2))


def test_cascade_hash_with_reference_projection(sets):
    d1, d2, _, _ = sets
    v = np.arange(200) % 11 != 0
    proj = np.asarray(jdm.make_hash_projection(jax.random.PRNGKey(3)))
    mean = np.mean(np.concatenate([d1, d2]), axis=0)
    m_j = jdm.match_cascade_hash(*map(jnp.asarray, (d1, d2, v, v, proj, mean)), n_candidates=32)
    m_t = tdm.match_cascade_hash(*map(t, (d1, d2, v, v, proj, mean)), n_candidates=32)
    np.testing.assert_array_equal(m_t.idx2.numpy(), np.asarray(m_j.idx2))
    p = tdm.make_hash_projection(torch.Generator().manual_seed(0))
    assert p.shape == (128, 128) and p.dtype == torch.float32


def test_guided_matching_identical():
    n = 64
    d, d2, _ = (np.asarray(a) for a in _desc_sets(jax.random.PRNGKey(4), n=n, shuffle=False))
    rng = np.random.RandomState(4)
    xy1 = rng.uniform(0, 500, (n, 2)).astype(np.float32)
    F = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]], np.float32)
    xy2 = (xy1 + [30.0, 0.0] + 0.5 * rng.randn(n, 2)).astype(np.float32)
    v = np.arange(n) % 9 != 0
    args = (xy1, xy2, d, d2, v, v)
    m_j = jdm.guided_match_epipolar(jnp.asarray(F), *map(jnp.asarray, args), max_epipolar_px=2.0)
    m_t = tdm.guided_match_epipolar(t(F), *map(t, args), max_epipolar_px=2.0)
    np.testing.assert_array_equal(m_t.idx2.numpy(), np.asarray(m_j.idx2))
    H = np.array([[1.0, 0.0, 30.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    m_j = jdm.guided_match_homography(jnp.asarray(H), *map(jnp.asarray, args), max_transfer_px=3.0)
    m_t = tdm.guided_match_homography(t(H), *map(t, args), max_transfer_px=3.0)
    np.testing.assert_array_equal(m_t.idx2.numpy(), np.asarray(m_j.idx2))
    assert (m_t.idx2.numpy() >= 0).sum() > 0.7 * v.sum()


@pytest.fixture(scope="module")
def tree_data():
    """JAX's vocabulary tree on clustered descriptors, and per-image sets."""
    rng = np.random.RandomState(0)
    centers = rng.rand(30, 32).astype(np.float32)
    labels = np.repeat(np.arange(30), 40)
    X = (centers[labels] + 0.05 * rng.randn(len(labels), 32)).astype(np.float32)
    tree = jvt.build_voctree(jax.random.PRNGKey(3), jnp.asarray(X), n_children=4, n_levels=3)
    images = []
    for g, cl in enumerate([np.arange(0, 15), np.arange(15, 30)]):
        for _ in range(6):
            sel = np.concatenate([np.nonzero(labels == c)[0] for c in rng.choice(cl, 5, replace=False)])
            valid = rng.rand(len(sel)) > 0.1
            images.append((X[sel], valid))
    return X, tree, images


def test_voctree_from_reference(tree_data):
    X, jtree, images = tree_data
    ttree = convert.voctree_from_numpy(jtree, device="cpu")
    assert ttree.n_leaves == jtree.n_leaves == 64
    np.testing.assert_array_equal(tvt.quantize(ttree, t(X)).numpy(), np.asarray(jvt.quantize(jtree, jnp.asarray(X))))
    bows_j = jnp.stack([jvt.bow_vector(jtree, jnp.asarray(d), jnp.asarray(v)) for d, v in images])
    bows_t = torch.stack([tvt.bow_vector(ttree, t(d), t(v)) for d, v in images])
    np.testing.assert_array_equal(bows_t.numpy(), np.asarray(bows_j))
    db_j = jvt.build_database(jtree, bows_j)
    db_t = tvt.build_database(ttree, bows_t)
    np.testing.assert_allclose(db_t.tfidf.numpy(), np.asarray(db_j.tfidf), rtol=1e-5, atol=1e-6)
    for k in (2, 3, 20):
        np.testing.assert_array_equal(tvt.query_pairs(db_t, k), jvt.query_pairs(db_j, k))


def test_kmeans_with_reference_seeds(tree_data):
    X, _, _ = tree_data
    valid = np.arange(len(X)) < 1000
    key = jax.random.PRNGKey(5)
    c_j = np.asarray(jvt._kmeans_masked(key, jnp.asarray(X), jnp.asarray(valid), 8, 6))
    # the seeds JAX draws inside _kmeans_masked
    w = valid.astype(np.float32)
    seeds = np.asarray(jax.random.choice(key, len(X), (8,), replace=True, p=jnp.asarray(w / w.sum())))
    c_t = tvt._kmeans_masked(None, t(X), t(valid), 8, 6, idx=t(seeds).long())
    np.testing.assert_allclose(c_t.numpy(), c_j, rtol=1e-5, atol=1e-5)


def test_build_voctree_from_generator(tree_data):
    X, _, _ = tree_data
    tree = tvt.build_voctree(torch.Generator().manual_seed(0), t(X), n_children=4, n_levels=3)
    assert tree.centers.shape == (3, 64, 32)
    words = tvt.quantize(tree, t(X)).numpy()
    words2 = tvt.quantize(tree, t(X + 1e-4 * np.random.RandomState(1).randn(*X.shape).astype(np.float32))).numpy()
    assert (words == words2).mean() > 0.95
    assert len(np.unique(words)) > 0.5 * tree.n_leaves


def test_pair_lists_identical():
    for n in (2, 5, 9):
        np.testing.assert_array_equal(tvt.exhaustive_pairs(n), jvt.exhaustive_pairs(n))
        for w in (1, 3, 10):
            np.testing.assert_array_equal(tvt.sequential_pairs(n, w), jvt.sequential_pairs(n, w))
