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


def test_unported_branches_raise(runs, tmp_path):
    sfm, dense = runs["sfm"], runs["port"]["dense"]
    with pytest.raises(NotImplementedError):
        tst.depth_map_estimation(sfm, dense, str(tmp_path / "r"), refine=True, device="cpu")
    with pytest.raises(NotImplementedError):
        tst.depth_map_estimation(sfm, dense, str(tmp_path / "t"), tile_size=32, device="cpu")
    with pytest.raises(NotImplementedError):
        tst.depth_map_filtering(
            sfm, runs["port"]["depth"], str(tmp_path / "n"), compute_normal_maps=True,
            device="cpu",
        )


def test_stages_default_to_cuda(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tst.prepare_dense_scene(runs["sfm"], str(tmp_path / "d"))
