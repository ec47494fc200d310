"""The port's copy of the local-BA graph helpers against the JAX package's:
the same covisibility edges, distances and cam_fixed masks, exactly."""

import numpy as np
import pytest

from alicevision_tpu.sfm import local_ba as jlb
from alicevision_tpu_torch.sfm import local_ba as tlb


def _tracks(seed, n_views=12, n_tracks=300, K=6):
    rng = np.random.RandomState(seed)
    start = rng.randint(0, n_views, n_tracks)
    length = rng.randint(2, K + 1, n_tracks)
    tbl_view = (start[:, None] + np.arange(K)[None]) % n_views
    tbl_mask = np.arange(K)[None] < length[:, None]
    obs_view = tbl_view[tbl_mask]
    obs_lm = np.broadcast_to(np.arange(n_tracks)[:, None], tbl_view.shape)[tbl_mask]
    return tbl_view, tbl_mask, obs_view, obs_lm


@pytest.mark.parametrize("seed,min_shared", [(0, 8), (1, 30), (2, 1)])
def test_covisibility_and_masks_equal(seed, min_shared):
    tbl_view, tbl_mask, obs_view, obs_lm = _tracks(seed)
    e_j = jlb.covisibility_from_table(tbl_view, tbl_mask, min_shared)
    e_t = tlb.covisibility_from_table(tbl_view, tbl_mask, min_shared)
    assert e_t == e_j
    assert sorted(tlb.covisibility_edges(obs_view, obs_lm, min_shared)) == sorted(
        jlb.covisibility_edges(obs_view, obs_lm, min_shared)
    )
    assert sorted(e_t) == sorted(tlb.covisibility_edges(obs_view, obs_lm, min_shared))
    np.testing.assert_array_equal(
        tlb.graph_distances(12, e_t, [3, 7]), jlb.graph_distances(12, e_j, [3, 7])
    )
    posed = np.arange(12) != 5
    for new_views, dist in (([3], 1), ([3, 4], 2), ([5], 1)):
        np.testing.assert_array_equal(
            tlb.local_ba_fixed_mask(12, e_t, new_views, posed, dist),
            jlb.local_ba_fixed_mask(12, e_j, new_views, posed, dist),
        )
