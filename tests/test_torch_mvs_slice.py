"""The dense slice end to end: the JAX package's four stages and the port's
(on the CPU) on the same posed `.sfm`, at 5 views of 160x120 with 32 depth
planes — the small-size twin of chip_smoke.py's main path."""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from alicevision_tpu.pipeline import stages as jst
from alicevision_tpu_torch.pipeline import stages as tst

torch.set_num_threads(1)

N_VIEWS = 5
N_DEPTHS = 32
FULL_MAP_FLOOR = 0.97  # see _assert_rule


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("slice"))
    sfm, gt = chip_smoke.make_posed_scene(
        work, n_views=N_VIEWS, wh=(160, 120), focal_px=140.0, n_points=600
    )
    port = chip_smoke.run_main_path(
        os.path.join(work, "port"), sfm, "cpu", n_depths=N_DEPTHS
    )
    ref = {k: os.path.join(work, "jax", k) for k in ("dense", "depth", "filtered")}
    ref["ply"] = os.path.join(work, "jax", "cloud.ply")
    jst.prepare_dense_scene(sfm, ref["dense"])
    jst.depth_map_estimation(sfm, ref["dense"], ref["depth"], n_depths=N_DEPTHS)
    jst.depth_map_filtering(sfm, ref["depth"], ref["filtered"], min_consistent=2)
    jst.meshing_point_cloud(sfm, ref["filtered"], ref["ply"])
    return {"sfm": sfm, "gt": gt, "port": port, "ref": ref, "work": work}


def _maps(runs, key, suffix):
    return [
        (np.load(os.path.join(runs["port"][key], f"{v}{suffix}")),
         np.load(os.path.join(runs["ref"][key], f"{v}{suffix}")))
        for v in range(1, N_VIEWS + 1)
    ]


def test_dense_images_match(runs):
    for out, ref in _maps(runs, "dense", ".npy"):
        assert out.shape == (120, 160)
        np.testing.assert_allclose(out, ref, atol=1e-5)


def test_depth_maps_match(runs):
    pairs = _maps(runs, "depth", "_depth.npy")
    rel = np.concatenate(
        [(np.abs(out - ref) / np.abs(ref)).ravel() for out, ref in pairs]
    )
    # the cost volumes are float32 rounding apart (see test_torch_similarity),
    # so argmin near-ties may pick a neighbouring plane at a few pixels
    assert (rel < 0.005).mean() >= 0.99
    for out, ref in pairs:
        assert out.shape == ref.shape == (60, 80) and np.isfinite(out).all()
    for out, ref in _maps(runs, "depth", "_sim.npy"):
        assert out.shape == (60, 80)


def test_depth_maps_meet_gt_floors(runs):
    # the port's maps against the rendered GT, at this size's own scale:
    # 32 planes leave a coarser grid than the card run's 256
    for v, (out, _) in enumerate(_maps(runs, "depth", "_depth.npy")):
        med, frac = chip_smoke.depth_stats(out, runs["gt"][v, ::2, ::2])
        assert med < 0.03 and frac > 0.15


def test_filtered_masks_match(runs):
    agree = [((out > 0) == (ref > 0)).mean() for out, ref in _maps(runs, "filtered", "_depth.npy")]
    assert np.mean(agree) >= 0.99


def test_point_clouds_match(runs):
    def count(path):
        with open(path) as f:
            head = [next(f) for _ in range(10)]
        assert head[-1] == "end_header\n"
        return int(head[2].split()[-1])

    n_port, n_ref = count(runs["port"]["ply"]), count(runs["ref"]["ply"])
    assert n_port == runs["port"]["n_points"] > 1000
    assert abs(n_port - n_ref) <= 0.01 * n_ref
    assert runs["port"]["seconds"].keys() == {
        "prepareDenseScene", "depthMapEstimation", "depthMapFiltering", "meshing",
    }


def _gather_tiles(runs, monkeypatch):
    """The JAX stage's uniform tiles take the gather sweep, as the port
    sends every tile of a map of more than one tile (four 48-px tiles of
    these 80x60 maps). The JAX stage gates its tiles on the poses alone
    (ROADMAP.md §3), so its batched tile sweep gets method="gather"."""
    from alicevision_tpu.mvs import sharded as jsh
    from alicevision_tpu_torch.mvs.sharded import make_tiles

    assert len(make_tiles(60, 80, 48, 16, clamp=True)) == 4
    batched = jsh._batched_sgm_jit

    def gather(*args, **kw):
        return batched(*args[:7], args[7]._replace(method="gather"), *args[8:], **kw)

    monkeypatch.setattr(jsh, "_batched_sgm_jit", gather)


def _depth_pair(runs, tmp_path, name, views=(1,), **kw):
    """The port's and the JAX package's depthMapEstimation on the fixture's
    dense images with the same options, for the first len(views) views."""
    out = {}
    for pkg, st in (("port", tst), ("jax", jst)):
        folder = str(tmp_path / f"{name}_{pkg}")
        extra = {"device": "cpu"} if pkg == "port" else {}
        st.depth_map_estimation(
            runs["sfm"], runs["ref"]["dense"], folder, n_depths=N_DEPTHS,
            range_size=len(views), **kw, **extra,
        )
        out[pkg] = [np.load(os.path.join(folder, f"{v}_depth.npy")) for v in views]
        for v in views:
            assert np.load(os.path.join(folder, f"{v}_sim.npy")).shape == (60, 80)
    return out["port"], out["jax"]


def _assert_rule(port, ref, gt):
    """The rule of test_depth_maps_match on the pixels where the rendered
    scene has a surface, and a floor over the whole map. Where the scene
    has no surface (the background, ~40 % of these views) the ZNCC costs
    are flat and argmin ties flip between the packages' float32 volumes: a
    tiled map's 48-px tiles hold few textured pixels, and its top-left tile
    disagrees there on ~2 % of the view. Over the whole map the three
    branch tests read 0.9853 (refine), 0.9873 (tiled) and 0.9781 (tiled +
    refine) within 0.5 %, and 1.0 on the surface; FULL_MAP_FLOOR keeps a
    fault in the background failing."""
    rel = [np.abs(o - r) / np.abs(r) for o, r in zip(port, ref)]
    on_surface = np.concatenate([e[g[::2, ::2] > 0] for e, g in zip(rel, gt)])
    assert len(on_surface) > 0.3 * len(port) * 60 * 80
    assert (on_surface < 0.005).mean() >= 0.99
    assert (np.concatenate([e.ravel() for e in rel]) < 0.005).mean() >= FULL_MAP_FLOOR
    for o in port:
        assert o.shape == (60, 80) and np.isfinite(o).all()


def test_refine_branch_matches(runs, tmp_path):
    port, ref = _depth_pair(runs, tmp_path, "refine", views=(1, 2), refine=True, color_opt_iters=5)
    _assert_rule(port, ref, runs["gt"])
    # refined maps against the rendered GT, at the floors of the plain maps
    for v, out in enumerate(port):
        med, frac = chip_smoke.depth_stats(out, runs["gt"][v, ::2, ::2])
        assert med < 0.03 and frac > 0.15


def test_tiled_branch_matches(runs, tmp_path, monkeypatch):
    # 80x60 maps in 48-px tiles with 16 overlap: four clamped 48x48 tiles
    _gather_tiles(runs, monkeypatch)
    port, ref = _depth_pair(runs, tmp_path, "tiled", views=(1, 2), tile_size=48, tile_overlap=16)
    _assert_rule(port, ref, runs["gt"])


def test_tiled_refine_branch_matches(runs, tmp_path, monkeypatch):
    _gather_tiles(runs, monkeypatch)
    port, ref = _depth_pair(
        runs, tmp_path, "tiled_refine", tile_size=48, tile_overlap=16, refine=True, color_opt_iters=5,
    )
    _assert_rule(port, ref, runs["gt"])


def test_normal_maps_match(runs, tmp_path):
    from alicevision_tpu_torch.image.io import read_image

    # both stages filter the JAX package's depth maps, so they fit normals
    # to the same filtered depths
    out = {}
    for pkg, st in (("port", tst), ("jax", jst)):
        folder = str(tmp_path / pkg)
        extra = {"device": "cpu"} if pkg == "port" else {}
        st.depth_map_filtering(
            runs["sfm"], runs["ref"]["depth"], folder, min_consistent=2, compute_normal_maps=True,
            **extra,
        )
        out[pkg] = {
            v: (np.load(os.path.join(folder, f"{v}_depth.npy")),
                read_image(os.path.join(folder, f"{v}_normalMap.exr")))
            for v in range(1, N_VIEWS + 1)
        }
    for v in range(1, N_VIEWS + 1):
        (d_port, n_port), (d_ref, n_ref) = out["port"][v], out["jax"][v]
        np.testing.assert_array_equal(d_port > 0, d_ref > 0)
        assert n_port.shape == (60, 80, 3)
        valid = (n_ref != -1).any(-1)
        np.testing.assert_array_equal((n_port != -1).any(-1), valid)
        np.testing.assert_allclose(np.linalg.norm(n_port[valid], axis=-1), 1.0, atol=1e-4)
        # float32 plane fits (see test_torch_normals): 1e-3 on 99 %
        assert (np.abs(n_port - n_ref).max(-1)[valid] < 1e-3).mean() >= 0.99


def test_stages_default_to_cuda(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tst.prepare_dense_scene(runs["sfm"], str(tmp_path / "d"))
