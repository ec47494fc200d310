"""The port's depth-map filtering and fusion against the JAX reference, on
the CPU, on rendered ground-truth depth maps with noise and holes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu.mvs import fusion as jfu
from alicevision_tpu.utils.rendered import render_views
from alicevision_tpu_torch.mvs import fusion as tfu

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def maps():
    _, gt, K, R, c = render_views(n_views=5, wh=(80, 60), focal_px=70.0, arc=0.6)
    rng = np.random.RandomState(0)
    depths = gt * (1.0 + 0.004 * rng.randn(*gt.shape)).astype(np.float32)
    depths[rng.rand(*gt.shape) < 0.05] = -1.0  # holes
    depths[gt <= 0] = -1.0
    V = len(depths)
    return {
        "depths": depths.astype(np.float32),
        "K": np.tile(K[None], (V, 1, 1)).astype(np.float32),
        "R": R.astype(np.float32),
        "c": c.astype(np.float32),
    }


def _args(m, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return [conv(np.array(m[k])) for k in ("depths", "K", "R", "c")]


def _check(out, ref):
    (f_t, n_t), (f_j, n_j) = out, ref
    f_t, n_t, f_j, n_j = f_t.numpy(), n_t.numpy(), np.asarray(f_j), np.asarray(n_j)
    # projections are float32 rounding apart, so a pixel that lands within an
    # ulp of a rounding or tolerance boundary may flip: 99.9% must agree
    assert (n_t == n_j).mean() > 0.999
    assert ((f_t > 0) == (f_j > 0)).mean() > 0.999
    both = (f_t > 0) & (f_j > 0)
    np.testing.assert_array_equal(f_t[both], f_j[both])  # kept depths are the input


@pytest.mark.parametrize("min_consistent", [2, 3])
def test_consistency_filter_matches(maps, min_consistent):
    ref = jfu.consistency_filter(*_args(maps, "jax"), min_consistent=min_consistent)
    out = tfu.consistency_filter(*_args(maps, "torch"), min_consistent=min_consistent)
    _check(out, ref)


@pytest.mark.parametrize("k", [1, 2])
def test_consistency_filter_ring_matches(maps, k):
    ref = jfu.consistency_filter_ring(*_args(maps, "jax"), k=k, min_consistent=2)
    out = tfu.consistency_filter_ring(*_args(maps, "torch"), k=k, min_consistent=2)
    _check(out, ref)
    assert tfu._ring_offsets(5, k) == jfu._ring_offsets(5, k)


@pytest.mark.parametrize("voxel", [0.0, 0.05])
def test_fuse_point_cloud_matches(maps, voxel):
    args = (maps["depths"], None, maps["K"], maps["R"], maps["c"])
    p_j, c_j, v_j = jfu.fuse_point_cloud(*args, voxel_size=voxel)
    p_t, c_t, v_t = tfu.fuse_point_cloud(*args, voxel_size=voxel, device="cpu")
    if voxel == 0.0:
        np.testing.assert_array_equal(v_t, v_j)
        np.testing.assert_array_equal(c_t, c_j)
        # world points of a scene ~5 units across: float32 rounding
        np.testing.assert_allclose(p_t, p_j, atol=1e-5)
    else:
        # voxel keys floor the points, so a point within rounding of a voxel
        # face may hash elsewhere: counts within 1%
        assert abs(len(p_t) - len(p_j)) <= 0.01 * len(p_j)


def test_depth_range_from_landmarks_matches(maps):
    pts = np.random.RandomState(1).randn(200, 3)
    for v in range(3):
        a = jfu.depth_range_from_landmarks(pts, maps["R"][v].astype(np.float64), maps["c"][v])
        b = tfu.depth_range_from_landmarks(pts, maps["R"][v].astype(np.float64), maps["c"][v])
        assert a == b
    behind = jfu.depth_range_from_landmarks(-maps["c"][:1] * 10, maps["R"][0], maps["c"][0])
    assert tfu.depth_range_from_landmarks(-maps["c"][:1] * 10, maps["R"][0], maps["c"][0]) == behind


def test_fuse_point_cloud_needs_device_or_cpu(maps):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    with pytest.raises(RuntimeError):
        tfu.fuse_point_cloud(maps["depths"], None, maps["K"], maps["R"], maps["c"])
