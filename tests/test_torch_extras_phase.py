"""chip_smoke.py's `extras` phase on the CPU at a small size, and its gates.

The phase (`chip_smoke.run_extras_phase`) runs AKAZE and AKAZE-MLDB with
F-filtered matching, the homography-growing filter, K-VLD and the
photometric filter on one pair's putative matches, keyframeSelection on a
rendered sequence and the eleven subcommands of ROADMAP item 13 (a), each
of the last three on the device and on the CPU (here the CPU twice, so the
two must agree exactly). Its readings against the truth are held to loose
bounds at this size; `extras_misses` is held to pass a row at gates set
from its own readings and to name each planted fault.
"""

import os

import pytest
import torch

from alicevision_tpu_torch.pipeline import cli as tcli

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def extras_phase(tmp_path_factory):
    """chip_smoke.py's extras phase on the CPU at a small size: 3 rendered
    320x240 views, the cli phase's outputs made by the port's stages (SIFT
    at 512 keypoints), the posed scene as the reconstruction, a 6-frame
    160x120 keyframe sequence and 2 tree draws."""
    import chip_smoke
    from alicevision_tpu_torch.pipeline import stages as tst

    work = tmp_path_factory.mktemp("extras")
    posed, _ = chip_smoke.make_posed_scene(str(work), n_views=3, wh=(320, 240), focal_px=300.0, arc=0.2,
                                           n_points=300)
    cli = work / "cli"
    os.makedirs(cli)
    init, feats, pairs, matches = (str(cli / f) for f in ("cameraInit.sfm", "features", "pairs.txt", "matches.npz"))
    tst.camera_init(str(work / "images"), init, default_focal_px=300.0, device="cpu")
    tst.feature_extraction(init, feats, max_keypoints=512, downscale_to=0, device="cpu")
    tst.image_matching(init, feats, pairs, method="exhaustive", device="cpu")
    tst.feature_matching(init, feats, pairs, matches, device="cpu")
    assert tcli.main(["tracksBuilding", "--input", init, "--features", feats, "--matches", matches, "--output",
                      str(cli / "tracks.npz"), *CPU]) == 0
    kf = dict(chip_smoke.EXTRAS_KEYFRAMES, n_frames=6, wh=(160, 120), focal_px=140.0)
    row = chip_smoke.run_extras_phase("cpu", str(work), posed, str(cli), str(work / "images"), recon_sfm=posed,
                                      kf_cfg=kf, draws=2)
    return row, kf


def test_chip_smoke_extras_phase_on_cpu(extras_phase):
    row, kf = extras_phase
    f = row["front"]
    for d, dim in (("akaze", 64), ("akaze_mldb", 486)):
        assert min(f[d]["keypoints_per_view"]) > 100 and f[d]["desc_dim"] == dim and f[d]["desc_dtype"] == "float32"
        assert f[d]["matches"] > 50 and f[d]["median_sampson_px"] < 1.0, f[d]
    hg = f["homography_growing"]
    assert hg["matches"] > 50 and hg["median_sampson_px"] < 2.0, hg
    assert f["akaze_card_cpu"]["frac_matched"] == 1.0  # the CPU twice
    fl = row["filters"]
    assert fl["agree"] == {"kvld": 1.0, "photometric": 1.0} and fl["zncc_max_abs_diff"] == 0.0
    for k in ("kvld", "photometric"):
        # the filters keep matches no farther from the true epipolar geometry
        assert 0 < fl["card"][k]["kept"] <= fl["card"]["putative"]["kept"]
        assert fl["card"][k]["median_sampson_px"] <= fl["card"]["putative"]["median_sampson_px"]
    kfr = row["keyframes"]
    assert kfr["equal"] and kfr["card"]["regular"] == [f"f{k:03d}.npy" for k in range(0, kf["n_frames"], kf["step"])]
    assert kfr["card"]["smart"] and all(int(n[1:4]) in kfr["sharp"] or n == "f000.npy" for n in kfr["card"]["smart"])
    t = row["tools"]
    assert t["byte_differ"] == [] and t["covariances"]["ids_equal"] and t["covariances"]["finite"]
    assert t["covariances"]["views"] == 3 and t["covariances"]["max_diff_of_largest"] == 0.0
    assert set(t["seconds"]["card"]) == {"exportKeypoints", "exportMatches", "exportTracks", "importMiddlebury",
                                         "voctreeCreation", "voctreeStatistics", "voctreeQueryUtility",
                                         "computeUncertainty", "exportMVSTexturing", "exportMatlab",
                                         "exportMeshroomMaya"}
    assert t["voctree_sweep"]["draws"] == 2 and t["voctree_sweep"]["of"] == 4
    assert not any(row["sgm_launches"].values())


def test_extras_gates_report_planted_faults(extras_phase):
    """extras_misses passes the row at gates set from its own readings and
    names each planted fault."""
    import copy

    import chip_smoke

    row, _ = extras_phase
    f, fl = row["front"], row["filters"]["card"]
    ref = {d: {"matches": f[d]["matches"], "median_sampson_px": f[d]["median_sampson_px"]}
           for d in ("akaze", "akaze_mldb", "homography_growing")}
    ref.update({k: fl[k] for k in ("putative", "kvld", "photometric")})
    ref.update(keyframes_smart=row["keyframes"]["card"]["smart"], keyframes_regular=row["keyframes"]["card"]["regular"],
               voctree={"draws": 2}, voctree_total_gate=row["tools"]["voctree_sweep"]["total"])
    assert chip_smoke.extras_misses(row, ref) == []

    def planted(edit):
        bad = copy.deepcopy(row)
        edit(bad)
        return [m.split(":")[0] for m in chip_smoke.extras_misses(bad, ref)]

    def far(r):
        r["front"]["akaze"]["median_sampson_px"] = 10.0

    def disagree(r):
        r["filters"]["agree"]["kvld"] = 0.5

    def keyframes(r):
        r["keyframes"]["card"]["smart"] = ["f002.npy"]

    def bytes_differ(r):
        r["tools"]["byte_differ"] = ["matlab"]

    def retrieval(r):
        r["tools"]["voctree_sweep"]["total"] = ref["voctree_total_gate"] - 1

    assert planted(far) == ["akaze"]
    assert planted(disagree) == ["kvld"]
    assert planted(keyframes) == ["keyframeSelection"]
    assert planted(bytes_differ) == ["the card's outputs differ from the CPU's"]
    assert planted(retrieval) == ["voctreeQueryUtility"]
