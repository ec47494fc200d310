"""The port's tiling (mvs/sharded.py) against the JAX package, on the CPU:
tile ROIs and the host merge exactly, the device merge at atol 1e-5, and
batched and tiled SGM maps of a rendered 128x96 view (64-px tiles, D = 16)
by the rule of test_torch_mvs_slice (>= 99 % of the pixels within 0.5 %).

The port sends every tile of a map of more than one tile to the gather
sweep, where the JAX package's pose gate sends it through the rectified
sweep, which misses on a crop off the image's centre (ROADMAP.md §3). So
the tiled map's reference is JAX's per-tile gather sweep, merged by JAX's
`merge_tiles`, and a test holds JAX's divergence on such a tile."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu.mvs import plane_sweep as jps
from alicevision_tpu.mvs import sharded as jsh
from alicevision_tpu.utils.rendered import render_views
from alicevision_tpu_torch.mvs import plane_sweep as tps
from alicevision_tpu_torch.mvs import sharded as tsh
from alicevision_tpu_torch.mvs.rectified import rectification_ok

torch.set_num_threads(1)

W, H = 128, 96


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _rule(out, ref):
    return (np.abs(out - ref) / np.abs(ref) < 0.005).mean() >= 0.99


@pytest.fixture(scope="module")
def scene():
    imgs, _, K, R, c = render_views(n_views=3, wh=(W, H), focal_px=110.0, arc=0.3)
    K = K.astype(np.float32)
    R_rel = np.stack([R[t] @ R[0].T for t in (1, 2)]).astype(np.float32)
    t_rel = np.stack([R[t] @ (c[0] - c[t]) for t in (1, 2)]).astype(np.float32)
    # the second pair moved along the view axis instead fails the gate
    t_fwd = t_rel.copy()
    t_fwd[1] = R[0] @ (-0.4 * R[0][2])
    R_fwd = R_rel.copy()
    R_fwd[1] = np.eye(3)
    assert all(rectification_ok(R_rel[i], t_rel[i]) for i in range(2))
    assert not rectification_ok(R_fwd[1], t_fwd[1])
    return {"imgs": imgs, "K": K, "Kt": np.stack([K, K]), "pairs": {
        "rectified": (R_rel, t_rel), "gather": (R_fwd, t_fwd)}}


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("hw,tile,overlap", [
    ((96, 128), 64, 16), ((1088, 1920), 1024, 128), ((60, 80), 48, 16), ((50, 50), 64, 8),
    ((300, 200), 100, 0),
])
def test_make_tiles_exact(hw, tile, overlap, clamp):
    assert tsh.make_tiles(*hw, tile, overlap, clamp) == jsh.make_tiles(*hw, tile, overlap, clamp)


def _random_tiles(rois, seed):
    rng = np.random.RandomState(seed)
    tiles = []
    for (y0, y1, x0, x1) in rois:
        m = rng.uniform(2.0, 9.0, (y1 - y0, x1 - x0)).astype(np.float32)
        m[rng.rand(*m.shape) < 0.2] = -1.0
        tiles.append(((y0, y1, x0, x1), m))
    return tiles


@pytest.mark.parametrize("clamp", [False, True])
def test_merge_tiles_exact(clamp):
    rois = jsh.make_tiles(H, W, 64, 16, clamp)
    tiles = _random_tiles(rois, 0)
    out = tsh.merge_tiles(tiles, H, W)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, jsh.merge_tiles(tiles, H, W))


def test_device_merge_matches():
    rois = jsh.make_tiles(H, W, 64, 16, clamp=True)
    stack = np.stack([m for _, m in _random_tiles(rois, 1)])
    ref = np.asarray(jsh._merge_tiles_jit(_j(stack), tuple(rois), (H, W)))
    out = tsh._merge_tiles_device(_t(stack), rois, (H, W)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    # float32 on the device, float64 on the host: the same map to 1e-5
    np.testing.assert_allclose(out, tsh.merge_tiles(list(zip(rois, stack)), H, W), atol=1e-5)


def _jax_tile(scene, crop_roi, t_imgs, R_rel, t_rel, method, n_depths=16):
    """JAX's per-tile SGM map of one crop by `method` (its `_tile_sgm_jit`,
    whose plane list is explicit, so `params.method` holds)."""
    y0, y1, x0, x1 = crop_roi
    Kc = scene["K"].copy()
    Kc[0, 2] -= x0
    Kc[1, 2] -= y0
    depths = np.asarray(jps.inverse_depth_planes(3.0, 10.0, n_depths), np.float32)
    d, _ = jsh._tile_sgm_jit(_j(scene["imgs"][0][y0:y1, x0:x1]), _j(t_imgs), _j(Kc), _j(scene["Kt"]), _j(R_rel),
                             _j(t_rel), _j(depths), jps.SgmParams(n_depths=n_depths, method=method))
    return np.asarray(d), Kc


@pytest.mark.parametrize("method", ["rectified", "gather"])
def test_sgm_depth_map_tiled_matches(scene, method):
    """`method` names the pose gate's verdict. The reference is JAX's
    per-tile gather sweeps merged by JAX's merge_tiles (with the poses that
    fail the gate, JAX's tiled map is the same gather map)."""
    R_rel, t_rel = scene["pairs"][method]
    t_imgs = np.stack([scene["imgs"][1], scene["imgs"][2 if method == "rectified" else 0]])
    args = (scene["imgs"][0], t_imgs, scene["K"], scene["Kt"], R_rel, t_rel, 3.0, 10.0)
    tiles = [(roi, _jax_tile(scene, roi, t_imgs, R_rel, t_rel, "gather")[0])
             for roi in jsh.make_tiles(H, W, 64, 16, clamp=True)]
    ref = jsh.merge_tiles(tiles, H, W)
    if method == "gather":
        np.testing.assert_allclose(
            ref, jsh.sgm_depth_map_tiled(*args, jps.SgmParams(n_depths=16), tile=64, overlap=16), atol=1e-5)
    out = tsh.sgm_depth_map_tiled(*args, tps.SgmParams(n_depths=16), tile=64, overlap=16, device="cpu")
    assert out.shape == (H, W) and out.device.type == "cpu"
    assert _rule(out.numpy(), ref)


def _steps(a, b, n_depths=16):
    """Median |a - b| in steps of the 3-10 inverse-depth plane list, where
    both maps are valid."""
    v = (a > 0) & (b > 0)
    step = b[v] ** 2 * (1.0 / 3.0 - 1.0 / 10.0) / (n_depths - 1)
    return float(np.median(np.abs(a[v] - b[v]) / step))


def test_off_centre_tile_jax_diverges_port_does_not(scene):
    """The bottom-right 64-px tile, principal point (-32, -16) px off its
    centre: JAX's rectified sweep (what its pose gate picks) misses its
    gather sweep by more than one depth step at the median; the port
    sends the tile to the gather sweep, within a step of JAX's."""
    R_rel, t_rel = scene["pairs"]["rectified"]
    t_imgs = np.stack([scene["imgs"][1], scene["imgs"][2]])
    roi = (32, 96, 64, 128)
    rect, Kc = _jax_tile(scene, roi, t_imgs, R_rel, t_rel, "rectified")
    gather, _ = _jax_tile(scene, roi, t_imgs, R_rel, t_rel, "gather")
    assert _steps(rect, gather) > 1.0
    out = tsh.sgm_depth_map_tiled(scene["imgs"][0], t_imgs, scene["K"], scene["Kt"], R_rel, t_rel, 3.0, 10.0,
                                  tps.SgmParams(n_depths=16), tile=64, overlap=16, device="cpu")
    port, _ = tps.sgm_depth_map(_t(scene["imgs"][0][32:96, 64:128]), _t(t_imgs), _t(Kc), _t(scene["Kt"]),
                                _t(R_rel), _t(t_rel), 3.0, 10.0, tps.SgmParams(n_depths=16, method="gather"))
    assert _steps(port.numpy(), gather) < 1.0
    assert _rule(port.numpy(), gather)
    assert out.shape == (H, W)


@pytest.mark.parametrize("tile,pairs,swept", [
    (64, "rectified", ["gather"] * 6), (64, "gather", ["gather"] * 6),  # six 64-px tiles of 128x96
    (128, "rectified", ["rectified"]), (128, "gather", ["gather"]),
])
def test_tile_gate_decisions(scene, monkeypatch, tile, pairs, swept):
    """The sweep each tile takes: the gather sweep on every tile of a map
    of more than one tile whatever the poses, the pose gate's verdict on
    one ROI."""
    R_rel, t_rel = scene["pairs"][pairs]
    taken = []

    def record(ref, *args, **kw):
        taken.append(args[7].method)
        return torch.zeros_like(ref), torch.zeros_like(ref)

    monkeypatch.setattr(tsh, "sgm_depth_map", record)
    tsh.sgm_depth_map_tiled(scene["imgs"][0], scene["imgs"][1:], scene["K"], scene["Kt"], R_rel, t_rel, 3.0, 10.0,
                            tps.SgmParams(n_depths=16), tile=tile, overlap=16, device="cpu")
    assert taken == swept


@pytest.mark.parametrize("method", ["rectified", "gather"])
def test_untiled_map_keeps_its_path(scene, method):
    """An image no larger than a tile is one ROI: its map is the pose-gated
    sgm_depth_map's, bit for bit, as before the tile gate."""
    R_rel, t_rel = scene["pairs"][method]
    t_imgs = np.stack([scene["imgs"][1], scene["imgs"][2 if method == "rectified" else 0]])
    args = (scene["imgs"][0], t_imgs, scene["K"], scene["Kt"], R_rel, t_rel)
    out = tsh.sgm_depth_map_tiled(*args, 3.0, 10.0, tps.SgmParams(n_depths=16), tile=128, overlap=16, device="cpu")
    ref, _ = tps.sgm_depth_map(*map(_t, args), 3.0, 10.0, tps.SgmParams(n_depths=16, method=method))
    assert torch.equal(out, ref)


def test_batched_sgm_matches(scene):
    R_rel, t_rel = scene["pairs"]["rectified"]
    img = scene["imgs"][0]
    crops = np.stack([img[0:48, 0:48], img[40:88, 60:108]])
    Kc = np.stack([scene["K"]] * 2)
    Kc[1, 0, 2] -= 60
    Kc[1, 1, 2] -= 40
    depths = np.stack([np.asarray(jps.inverse_depth_planes(3.0, 10.0, 8)),
                       np.asarray(jps.inverse_depth_planes(4.0, 9.0, 8))])

    def batch(a):
        return np.broadcast_to(a[None], (2,) + a.shape).copy()

    args = (crops, batch(scene["imgs"][1:]), Kc, batch(scene["Kt"]), batch(R_rel), batch(t_rel), depths)
    ref, _ = jsh._batched_sgm_jit(*map(_j, args), jps.SgmParams(n_depths=8, method="rectified"))
    out, sim = tsh.batched_sgm(*map(_t, args), tps.SgmParams(n_depths=8, method="rectified"))
    assert out.shape == sim.shape == (2, 48, 48)
    assert _rule(out.numpy(), np.asarray(ref))
