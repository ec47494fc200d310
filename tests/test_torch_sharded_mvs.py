"""The port's view-sharded depth maps and fusion (mvs/sharded.py) on 2 and
4 gloo ranks: the ring-halo consistency filter bit-exact with the port's
consistency_filter_ring on every branch (one hop, whole blocks chained when
a rank holds fewer views than k, k = 0, a rank's block or the whole stack
passed), counts array_equal, close to the JAX package's
make_sharded_consistency_filter; one rank's local wraparound; the halo's
bytes; and make_sharded_sgm on 2 ranks against the JAX package's at
test_torch_tiled.py::test_batched_sgm_matches's rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu.mvs import plane_sweep as jps
from alicevision_tpu.mvs import sharded as jsh
from alicevision_tpu.parallel.mesh import make_mesh as jmake_mesh
from alicevision_tpu.utils.rendered import render_views
from alicevision_tpu_torch.mvs import sharded as tsh
from alicevision_tpu_torch.mvs.fusion import consistency_filter_ring
from alicevision_tpu_torch.parallel import distributed as tdist
from alicevision_tpu_torch.parallel.mesh import make_mesh
from torch_rank_targets import HERE

torch.set_num_threads(1)

RANKS = (2, 4)
# (V, k): one hop at 2 ranks and chained blocks at 4 (8, 3); a halo of
# exactly a block, then chained single views (4, 3: k_eff = 2); one hop
# (8, 1); no neighbours (8, 0); the antipodal view counted once (8, 4)
CASES = np.array([(8, 3), (4, 3), (8, 1), (8, 0), (8, 4)])
H, W = 48, 64


def _stack():
    """tests/test_sharded_mvs.py's stack: a fronto plane at depth 5 seen by
    near-identical cameras, with an inconsistent patch in every view."""
    V = 8
    rng = np.random.RandomState(3)
    depths = np.full((V, H, W), 5.0, np.float32)
    for v in range(V):
        y, x = rng.randint(0, H - 8), rng.randint(0, W - 8)
        depths[v, y:y + 8, x:x + 8] = 2.0 + v * 0.3
    K = np.tile(np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32), (V, 1, 1))
    ang = np.linspace(0, 0.08, V)
    R = np.stack([np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32)
                  for a in ang])
    c = np.stack([np.array([0.2 * v, 0, 0], np.float32) for v in range(V)])
    return {"depths": depths, "K": K, "R": R, "c": c}


@pytest.fixture(scope="module")
def stack():
    return _stack()


@pytest.fixture(scope="module")
def ring(stack):
    """The port's single-process bounded filter of each case."""
    out = []
    for V, k in CASES:
        f, cnt = consistency_filter_ring(*(torch.from_numpy(stack[n][:V]) for n in ("depths", "K", "R", "c")),
                                         k=int(k))
        out.append((f.numpy(), cnt.numpy()))
    return out


@pytest.fixture(scope="module")
def ranks(stack, tmp_path_factory):
    inputs = dict(stack, cases=CASES)
    return {n: tdist.launch_local("torch_rank_targets:fusion_rank", n, inputs,
                                  str(tmp_path_factory.mktemp(f"fusion{n}")), timeout=120.0, path=[HERE])
            for n in RANKS}


@pytest.mark.parametrize("form", ["local", "whole"])
@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("n", RANKS)
def test_sharded_filter_bit_exact(ring, ranks, n, case, form):
    out = ranks[n][0]
    np.testing.assert_array_equal(out[f"case{case}.{form}.filt"], ring[case][0])
    np.testing.assert_array_equal(out[f"case{case}.{form}.counts"], ring[case][1])


@pytest.mark.parametrize("n", RANKS)
def test_halo_bytes(ranks, n):
    """2·k_eff maps a rank a hop, and ceil(k_eff / (V/S)) hops."""
    for case, (V, k) in enumerate(CASES):
        k_eff = min(int(k), V // 2)
        vs = V // n
        hops = -(-k_eff // vs) if k_eff else 0
        want = 2 * (vs * hops if k_eff > vs else k_eff) * H * W * 4
        for rank in ranks[n]:
            assert int(rank[f"case{case}.local.permute_bytes"]) == want, (case, n)


@pytest.mark.parametrize("n", RANKS)
def test_sharded_filter_matches_jax(stack, ranks, n):
    """JAX's shard_map filter on n virtual devices, the JAX test's k = 3."""
    mesh = jmake_mesh(n_view=n, n_landmark=1, devices=jax.devices()[:n])
    fs, cnt = jsh.make_sharded_consistency_filter(mesh, k=3)(*(jnp.asarray(stack[k]) for k in ("depths", "K", "R", "c")))
    out = ranks[n][0]
    assert np.allclose(out["case0.local.filt"], np.asarray(fs))
    assert np.array_equal(out["case0.local.counts"], np.asarray(cnt))
    assert (out["case0.local.filt"] > 0).mean() > 0.5
    assert (out["case0.local.filt"][0] > 0).mean() < 1.0


@pytest.mark.parametrize("case", range(len(CASES)))
def test_one_rank_is_a_wraparound(stack, ring, case):
    V, k = CASES[case]
    mesh = make_mesh()
    tdist.reset_comm_bytes()
    f, cnt = tsh.make_sharded_consistency_filter(mesh, k=int(k), device="cpu")(
        *(stack[n][:V] for n in ("depths", "K", "R", "c")))
    assert tdist.comm_bytes == {}
    np.testing.assert_array_equal(f.numpy(), ring[case][0])
    np.testing.assert_array_equal(cnt.numpy(), ring[case][1])
    assert tsh.gather_to_primary(f, mesh) is f


def test_stack_must_be_whole_or_a_block(stack):
    fuse = tsh.make_sharded_consistency_filter(make_mesh(), k=3, device="cpu")
    with pytest.raises(ValueError):
        fuse(stack["depths"][:5], stack["K"], stack["R"], stack["c"])


def test_sharded_sgm_matches(tmp_path):
    """Two crops of test_torch_tiled.py's rendered view, one a rank."""
    imgs, _, K, R, c = render_views(n_views=3, wh=(128, 96), focal_px=110.0, arc=0.3)
    K = K.astype(np.float32)
    R_rel = np.stack([R[t] @ R[0].T for t in (1, 2)]).astype(np.float32)
    t_rel = np.stack([R[t] @ (c[0] - c[t]) for t in (1, 2)]).astype(np.float32)
    crops = np.stack([imgs[0][0:48, 0:48], imgs[0][40:88, 60:108]]).astype(np.float32)
    Kc = np.stack([K] * 2)
    Kc[1, 0, 2] -= 60
    Kc[1, 1, 2] -= 40
    depths = np.stack([np.asarray(jps.inverse_depth_planes(3.0, 10.0, 8)),
                       np.asarray(jps.inverse_depth_planes(4.0, 9.0, 8))]).astype(np.float32)

    def batch(a):
        return np.broadcast_to(a[None], (2,) + a.shape).astype(np.float32)

    arrays = {"ref_imgs": crops, "t_imgs": batch(imgs[1:]), "K_ref": Kc, "K_t": batch(np.stack([K, K])),
              "R_rel": batch(R_rel), "t_rel": batch(t_rel), "depths": depths}
    mesh = jmake_mesh(n_view=2, n_landmark=1, devices=jax.devices()[:2])
    names = ("ref_imgs", "t_imgs", "K_ref", "K_t", "R_rel", "t_rel", "depths")
    ref, _ = jsh.make_sharded_sgm(mesh, jps.SgmParams(n_depths=8, method="rectified"))(
        *(jnp.asarray(arrays[k]) for k in names))
    out = tdist.launch_local("torch_rank_targets:sgm_rank", 2,
                             dict(arrays, n_depths=np.asarray(8), method=np.asarray("rectified")),
                             str(tmp_path), timeout=120.0, path=[HERE])
    depth, ref = out[0]["depth"], np.asarray(ref)
    assert depth.shape == (2, 48, 48) and "depth" not in out[1]
    assert (np.abs(depth - ref) / np.abs(ref) < 0.005).mean() >= 0.99
