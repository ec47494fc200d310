"""chip_smoke.py's `aux` phase on the CPU at a small size, and its gates.

The phase (`chip_smoke.run_aux_phase`) runs imageMasking over the dense
scene's views and a photograph, imageSegmentation by the classical scorer
and by the FCN writer's network, sfmColorHarmonize under known gains, and
the lidar chain (importE57 -> lidarMerging -> lidarDecimating ->
lidarMeshing), each on the device and on the CPU (here the CPU twice, so
the two must agree exactly). Here: 3 rendered 256x192 views, photographs of
600x400 and 300x200, the FCN at 4 channels and one block a stage, stations
of 48x24 rays. `aux_misses` is held to pass a row at gates set from its own
readings and to name each planted fault.
"""

import os

import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def aux_phase(tmp_path_factory):
    import chip_smoke
    from alicevision_tpu_torch.pipeline import stages as tst

    work = tmp_path_factory.mktemp("aux")
    chip_smoke.make_posed_scene(str(work), n_views=3, wh=(256, 192), focal_px=240.0, arc=0.2, n_points=200)
    cli = work / "cli"
    os.makedirs(cli)
    init, feats, pairs, matches = (str(cli / f) for f in ("cameraInit.sfm", "features", "pairs.txt", "matches.npz"))
    tst.camera_init(str(work / "images"), init, default_focal_px=240.0, device="cpu")
    tst.feature_extraction(init, feats, max_keypoints=512, downscale_to=0, device="cpu")
    tst.image_matching(init, feats, pairs, method="exhaustive", device="cpu")
    tst.feature_matching(init, feats, pairs, matches, device="cpu")
    cfg = dict(chip_smoke.AUX, photo_wh=(600, 400), mask_photo_wh=(300, 200),
               fcn=dict(width=4, blocks=(1, 1, 1, 1), classes=5, seed=0), lidar=dict(samples=(48, 24), cell=0.3, seed=0))
    return chip_smoke.run_aux_phase("cpu", str(work), str(cli), str(work / "images"), cfg=cfg)


def test_chip_smoke_aux_phase_on_cpu(aux_phase):
    row = aux_phase
    m = row["masks"]
    assert m["card_cpu_differ"] == [] and len(m["counts"]) == 3 + 3 + 1
    assert 0 < m["counts"]["photo_sky_mask.png"] < m["pixels"]["photo_sky_mask.png"]
    s = row["segmentation"]
    assert 0 < s["sky_classical_count"] < 600 * 400
    f = s["fcn"]
    assert f["mask_is_class0"] and f["tiles_in_grid"] == 2 and sum(f["label_counts"]) == 600 * 400
    t = f["tiles"]
    assert t["tiles"] == [[400, 512], [400, 152]] and t["max_abs_logit_diff"] == 0.0
    assert t["label_agreement"] == [1.0, 1.0] and t["card_label_counts"] == t["cpu_label_counts"]
    h = row["harmonize"]
    assert h["card"] == h["cpu"] and h["card_cpu_max_abs_diff"] == 0.0
    assert h["card"]["max_gain_rel_err"] < h["card"]["unharmonized_max_gain_rel_err"]
    li = row["lidar"]
    assert li["card_cpu_differ"] == [] and li["printed_differ"] == []
    assert li["merged"] == {"points": 3 * 48 * 24, "scans": 3} and 0 < li["decimated"]["points"] < 3 * 48 * 24
    assert li["mesh"]["faces"] > 100 and li["mesh_median_box_distance"] < 0.1
    assert set(row["commands"]["card"]) == {"imageMasking", "imageMasking#2", "imageMasking#3", "sfmColorHarmonize",
                                            "importE57", "lidarMerging", "lidarDecimating", "lidarMeshing",
                                            "imageSegmentation", "imageSegmentation#2"}
    assert not any(row["sgm_launches"].values())


def test_aux_gates_report_planted_faults(aux_phase):
    """aux_misses passes the row at gates set from its own readings and
    names each planted fault."""
    import copy

    import chip_smoke

    row = aux_phase
    t = row["segmentation"]["fcn"]["tiles"]
    ref = {"mask_counts": row["masks"]["counts"], "sky_classical_count": row["segmentation"]["sky_classical_count"],
           "fcn_sha256": row["segmentation"]["fcn"]["sha256"],
           "fcn_tiles": {"jax_label_counts": t["cpu_label_counts"], "port_cpu_label_counts": t["cpu_label_counts"],
                         "port_cpu_label_agreement": [1.0, 1.0]},
           "harmonize": row["harmonize"]["card"],
           "lidar": {k: row["lidar"][k] for k in ("merged", "decimated", "mesh_median_box_distance")}}
    g = dict(chip_smoke.AUX_GATES, decimated=(0, 10**9))
    assert chip_smoke.aux_misses(row, ref, g) == []

    def planted(edit):
        bad = copy.deepcopy(row)
        edit(bad)
        return [m.split(":")[0] for m in chip_smoke.aux_misses(bad, ref, g)]

    def mask_differs(r):
        r["masks"]["card_cpu_differ"] = ["views_auto/1_mask.png"]

    def logits(r):
        r["segmentation"]["fcn"]["tiles"]["max_rel_logit_diff"] = 0.01

    def labels(r):
        r["segmentation"]["fcn"]["tiles"]["card_label_counts"][0][0] += 1000

    def gains(r):
        r["harmonize"]["card"]["max_gain_rel_err"] += 0.2

    def lidar_bytes(r):
        r["lidar"]["card_cpu_differ"] = ["merged.ply"]

    def sgm(r):
        r["sgm_launches"] = {"sgm_axis_sweeps": 4}

    assert planted(mask_differs) == ["imageMasking"]
    assert planted(logits) == ["FCN tiles"]
    assert planted(labels) == ["FCN tiles"]
    assert planted(gains) == ["sfmColorHarmonize"]
    assert planted(lidar_bytes) == ["lidar"]
    assert planted(sgm) == ["the aux path launched SGM kernels"]
