"""The port's localization, rig and scene-tool subcommands (`pipeline/
cli_ext.py`) against the JAX CLI on the CPU, and a CPU run of
chip_smoke.py's `localization` phase at a small size.

The database is the hard scene's ring (40 views, rendered undistorted at
320x240 on the CPU) with SIFT features, sequential matches and landmarks
triangulated at the true poses (computeStructureFromKnownPoses).

- Host subcommands (sfmMerge, sfmSplitReconstructed, sfmTransfer,
  applyCalibration, sfmDistances, sfmRegression, frustumFiltering,
  rigTransform, sfmToRig) write byte-equal files and print equal JSON to
  the JAX CLI's on the same inputs; rigCalibration's sub-poses agree within
  1e-6 (a float32 quaternion average in each); generateSampleScene prints
  the same counts and the same cameras (its points come from another random
  stream).
- cameraLocalization and rigLocalization compile the JAX SIFT for ~30 s on
  the CPU, so the port's are held to the truth through the phase (every
  query localized within 2 deg and 2 % of the radius at this size) and to
  the port's own modules (the CLI's first query equals `localize_image`
  with the generator the CLI seeds); the modules are held to the JAX ones
  in tests/test_torch_localization.py.
- all 103 subcommands have a handler.
"""

import contextlib
import copy
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from alicevision_tpu.pipeline import cli as jcli
from alicevision_tpu.utils.synthetic import ring_scene_sfmdata
from alicevision_tpu_torch import sfmdata
from alicevision_tpu_torch.pipeline import cli as tcli
from alicevision_tpu_torch.pipeline import cli_ext, stages
from alicevision_tpu_torch.utils.rendered import _ring_cameras

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
WH, FOCAL = (320, 240), 225.0
N_QUERIES = 4
SEEDS = 2  # draws of the phase's sweep at this size (LOC_SWEEP_SEEDS on the card)


@contextlib.contextmanager
def built_once(tmp_path_factory, worker_id: str, name: str):
    """A folder `name` that one test run builds once and every test worker
    of the run reuses: (folder, built) under an exclusive file lock, where
    `built` tells whether an earlier holder finished it. Under xdist the
    folder sits in the run's shared temporary root, otherwise in the run's
    own."""
    import fcntl

    base = tmp_path_factory.getbasetemp()
    root = (base if worker_id == "master" else base.parent) / name
    root.mkdir(exist_ok=True)
    with open(root / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield root, (root / ".built").exists()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@pytest.fixture(scope="module")
def db(tmp_path_factory, worker_id):
    """(folder, database .sfm, features, posed truth .sfm, R_gt, c_gt),
    built once a test run (tests/test_torch_camera_localization_cli.py and
    test_torch_rig_localization_cli.py read it too)."""
    _, R_gt, c_gt = _ring_cameras(chip_smoke.HARD_VIEWS, 6.0, 1.2, FOCAL, WH, 0)
    with built_once(tmp_path_factory, worker_id, "locdb") as (root, built):
        if not built:
            _build_db(root, R_gt, c_gt)
            (root / ".built").touch()
    return root, str(root / "db.sfm"), str(root / "features"), str(root / "posed.sfm"), R_gt, c_gt


def _build_db(root, R_gt, c_gt):
    imgs = chip_smoke.render_at_poses(R_gt, c_gt, WH, FOCAL, (0.0, 0.0, 0.0), "cpu")
    os.makedirs(root / "images", exist_ok=True)
    for v, img in enumerate(imgs):
        np.save(root / "images" / f"view_{v:03d}.npy", img)
    init, feats = str(root / "init.sfm"), str(root / "features")
    stages.camera_init(str(root / "images"), init, default_focal_px=FOCAL, device="cpu")
    stages.feature_extraction(init, feats, max_keypoints=384, downscale_to=0, device="cpu")
    stages.image_matching(init, feats, str(root / "pairs.txt"), method="sequential", n_neighbors=2, device="cpu")
    stages.feature_matching(init, feats, str(root / "pairs.txt"), str(root / "matches.npz"), device="cpu")
    sc = sfmdata.load(init)
    for v in range(sc.n_views):
        sc.set_pose(v, R_gt[v], c_gt[v])
    posed = str(root / "posed.sfm")
    sfmdata.save(sc, posed)
    out = str(root / "db.sfm")
    assert tcli.main(["computeStructureFromKnownPoses", "--input", posed, "--features", feats, "--matches",
                      str(root / "matches.npz"), "--output", out, *CPU]) == 0


@pytest.fixture(scope="module")
def phase(db, tmp_path_factory):
    """The phase's row. Its commands and sweep extract each query's SIFT
    again at every run (68 extractions of 16 images, 0.4 s each on one
    thread); here an extraction is kept for the phase by its inputs."""
    root, sfm, feats, _, R_gt, c_gt = db
    work = str(tmp_path_factory.mktemp("locphase"))
    extract, seen = cli_ext._query_features, {}

    def once(path, row, dev, max_keypoints, downscale_to=0):
        key = (path, tuple(tuple(np.asarray(a.cpu()).ravel().tolist()) for a in row), str(dev), max_keypoints,
               downscale_to)
        if key not in seen:
            seen[key] = extract(path, row, dev, max_keypoints, downscale_to)
        return tuple(a.copy() for a in seen[key])

    mp = pytest.MonkeyPatch()
    mp.setattr(cli_ext, "_query_features", once)
    try:
        row = _run_phase(work, sfm, feats, R_gt, c_gt)
    finally:
        mp.undo()
    return work, row


def _run_phase(work, sfm, feats, R_gt, c_gt):
    return chip_smoke.run_localization_phase("cpu", work, sfm, feats, R_gt, c_gt, n_queries=N_QUERIES, wh=WH,
                                            focal_px=FOCAL, disto=(0.0, 0.0, 0.0), solver_batch=96, solver_cpu=32,
                                            marker_frames=4, sweep_seeds=SEEDS)


def test_chip_smoke_localization_phase_on_cpu(phase):
    _, row = phase
    rep = row["report"]
    assert set(row["commands"]) >= {"cameraLocalization", "cameraLocalization#4", "rigCalibration", "rigTransform",
                                    "sfmToRig", "rigLocalization", "rigLocalization#2", "frustumFiltering",
                                    "sfmSplitReconstructed", "sfmMerge", "sfmRegression", "sfmTransfer",
                                    "applyCalibration", "sfmDistances", "generateSampleScene"}
    assert set(row["seconds_per_query"]["voctree"]) == {"sift", "retrieval", "matching", "resection", "total"}
    for key in [f"camera_{m}" for m in chip_smoke.LOC_CAMERA_RUNS] + ["rig_joint", "rig_average"]:
        r = rep[key]
        # the 2x renders (640x480, not decimated) meet the 320-px database
        # at twice its scale: one query of the four is let go
        assert r["localized"] >= N_QUERIES - key.endswith("_2x"), (key, r)
        ok = [(a, c) for a, c in zip(r["rot_err_deg"], r["centre_err_frac"]) if a is not None]
        assert max(a for a, _ in ok) < 2.0 and max(c for _, c in ok) < 0.02, (key, r)
    # the sweep's draw 0 is the CLI's draw: the same queries right
    assert set(row["sweep"]) == set(chip_smoke.LOC_SWEEP_RUNS)
    for m, draws in row["sweep"].items():
        assert [d["seed"] for d in draws] == list(range(SEEDS))
        right = chip_smoke.right_wrong(rep[f"camera_{m}"], chip_smoke.LOC_GATES["rot_deg"],
                                       chip_smoke.LOC_GATES["centre_frac"])[0]
        assert draws[0]["right"] == right, (m, draws, rep[f"camera_{m}"])
    assert rep["subpose_rot_err_deg"] < 0.2 and rep["subpose_centre_err"] < 0.01
    assert rep["sfm_to_rig_cameras"] == N_QUERIES
    fr = rep["frustum"]
    assert fr["cli_equals_cpu"] and fr["card_equals_cpu"] and 0 < fr["pairs"] < fr["of"]
    sm = rep["split_merge"]
    assert sm["same_ids"] and sm["same_poses"] and sm["landmarks"][0] == sm["landmarks"][1] > 0
    assert rep["regression_self"]["center_dist_max"] == 0.0
    assert rep["sample_scene"] == {"views": 10, "landmarks": 100}
    for name, s in row["solvers"].items():
        if name in ("resection_dlt6", "epnp"):
            assert s["rot_err_deg_median"] < 0.01 and s["card_cpu_R_diff_median"] == 0.0, (name, s)
        else:
            assert s["recovered"] >= 0.8, (name, s)
    m = row["markers"]
    assert min(m["tags_detected"]) >= 6 and m["focal_err_frac"] < 0.02 and m["rms_px"] < 1.0, m
    assert not any(row["sgm_launches"].values())
    # at the card's gates, this size misses only the counts above its queries
    g = chip_smoke.LOC_GATES
    short = {f"{kind} {m}" for kind, gates in (("camera", g["localized"]), ("rig", g["rig_frames"]))
             for m, want in gates.items() if want > N_QUERIES}
    short |= {f"camera {m}" for m, want in g["localized_k"].items()
              if want > sum(d["right"] for d in row["sweep"][m])}
    assert {b.split(":")[0] for b in chip_smoke.localization_misses(row)} == short


def test_localization_gates_report_planted_faults(phase, monkeypatch):
    """localization_misses names a wrong pose reported as a success, an
    imprecise one that leaves too few right, and a wrong sub-pose."""
    _, row = phase
    g = chip_smoke.LOC_GATES
    # the direct run's gate at this size's count, so that it can be missed
    monkeypatch.setitem(g["localized"], "direct", N_QUERIES)

    def planted(edit):
        bad = copy.deepcopy(row)
        edit(bad["report"])
        return {b.split(":")[0] for b in chip_smoke.localization_misses(bad)} - {
            b.split(":")[0] for b in chip_smoke.localization_misses(row)}

    def wrong(rep):
        n = g["wrong"] + 1
        rep["camera_direct"]["rot_err_deg"][:n] = [88.7] * n

    # a run whose count gate this size can meet
    met = next(m for m, want in g["localized"].items() if 0 < want <= N_QUERIES)

    def imprecise(rep):
        r = rep[f"camera_{met}"]
        r["rot_err_deg"] = [2 * g["rot_deg"]] * len(r["rot_err_deg"])

    def subpose(rep):
        rep["subpose_rot_err_deg"] = 1.0

    assert planted(wrong) == {"camera direct"}
    assert planted(imprecise) == {f"camera {met}"}
    assert planted(subpose) == {"rigCalibration"}


def test_localization_k_draw_gates_report_planted_faults(phase, monkeypatch):
    """A K-draw total one under its gate, and one wrong success in one
    draw, are named; a row at its gates passes them."""
    _, row = phase
    g = chip_smoke.LOC_GATES
    for m, draws in row["sweep"].items():
        monkeypatch.setitem(g["localized_k"], m, sum(d["right"] for d in draws))
    base = {b.split(":")[0] for b in chip_smoke.localization_misses(row)}
    assert not any(b in base for b in (f"camera {m}" for m in row["sweep"]))
    m = "voctree_2x"

    def planted(edit):
        bad = copy.deepcopy(row)
        edit(bad["sweep"][m])
        return {b.split(":")[0] for b in chip_smoke.localization_misses(bad)} - base

    def one_under(draws):
        d = next(d for d in draws if d["right"])
        d["right"] -= 1

    def wrong_in_one_draw(draws):
        draws[-1]["wrong"].append({"query": "q_00.npy", "rot_deg": 88.7, "centre_frac": 0.4, "n_inliers": 12})

    assert planted(one_under) == {f"camera {m}"}
    assert planted(wrong_in_one_draw) == {f"camera {m}"}


def test_rig_gate_reads_the_tilt(phase, monkeypatch):
    """Rig frames 1.2 times the rig tolerance off are named on an untilted
    reconstruction and pass on one tilted 1.5 times rig_tilt_deg."""
    _, row = phase
    g = chip_smoke.LOC_GATES
    monkeypatch.setitem(g["rig_frames"], "joint", N_QUERIES)
    base = {b.split(":")[0] for b in chip_smoke.localization_misses(row)}
    assert "rig joint" not in base

    def planted(tilt):
        bad = copy.deepcopy(row)
        bad["report"]["database_tilt_deg"] = tilt
        r = bad["report"]["rig_joint"]
        r["centre_err_frac"] = [1.2 * g["rig_centre_frac"]] * len(r["centre_err_frac"])
        return {b.split(":")[0] for b in chip_smoke.localization_misses(bad)} - base

    assert planted(0.0) == {"rig joint"}
    assert planted(1.5 * g["rig_tilt_deg"]) == set()


def test_camera_localization_equals_module(db, phase):
    """The CLI's first direct query is `localize_image` with a generator
    seeded 0 on the same features."""
    from alicevision_tpu_torch.localization import localize_image

    _, _, feats, _, _, _ = db
    work, _ = phase
    sc = sfmdata.load(os.path.join(work, "localization", "database.sfm"))
    lm = cli_ext._build_landmark_index_from_features(sc, feats)
    row = sc.intrinsics_table().row(0)
    q = os.path.join(work, "localization", "loc_q0", "q_00.npy")
    desc, p = cli_ext._query_features(q, row, torch.device("cpu"), 2048, 1024)
    res = localize_image(torch.Generator().manual_seed(0), *lm, desc, p, float(np.mean(sc.scale[:, 0])),
                         (float(sc.sizes[0, 0]), float(sc.sizes[0, 1])), device="cpu")
    with open(os.path.join(work, "localization", "loc_direct.json")) as f:
        cli = json.load(f)["q_00.npy"]
    assert cli["success"] and res.success and cli["n_inliers"] == res.n_inliers
    np.testing.assert_array_equal(np.asarray(cli["R"]), res.R)
    np.testing.assert_array_equal(np.asarray(cli["c"]), res.c)


@pytest.fixture(scope="module")
def tool_inputs(db, phase, tmp_path_factory):
    """The inputs of the host subcommands: the rig scenes and the truth
    rig of the phase, a calibration file and a second scene."""
    root = tmp_path_factory.mktemp("toolin")
    work, _ = phase
    loc = os.path.join(work, "localization")
    calib = root / "calib.json"
    calib.write_text(json.dumps({"K": [[230.0, 0, 161.0], [0, 231.0, 119.0], [0, 0, 1]], "dist": [0.01, -0.002]}))
    from alicevision_tpu import sfmdata as jsd

    jsd.save(ring_scene_sfmdata(n_views=6, n_points=40, seed=2), str(root / "other.sfm"))
    return dict(cam0=os.path.join(loc, "loc_cam0.sfm"), cam1=os.path.join(loc, "loc_cam1.sfm"),
                rig=os.path.join(loc, "rig.json"), calib=str(calib), other=str(root / "other.sfm"))


def _host_commands(db, ti, o):
    _, sfm, _, posed, _, _ = db
    return {
        "sfmSplitReconstructed": ["--input", sfm, "--output", o("rec.sfm"), "--outputNonReconstructed", o("non.sfm")],
        "sfmMerge": ["--input", sfm, "--input2", ti["other"], "--output", o("merged.sfm")],
        "sfmMerge_aligned": ["--input", posed, "--input2", sfm, "--output", o("merged.sfm"), "--alignment"],
        "sfmTransfer": ["--input", posed, "--reference", ti["other"], "--output", o("t.sfm"), "--transferIntrinsics",
                        "--method", "from_filepath"],
        "applyCalibration": ["--input", sfm, "--calibration", ti["calib"], "--output", o("c.sfm")],
        "sfmDistances": ["--input", sfm, "--landmarksA", "0,1,5", "--landmarksB", "2,3,4"],
        "sfmDistances_extent": ["--input", sfm],
        "sfmRegression": ["--input", sfm, "--reference", posed],
        "frustumFiltering": ["--input", posed, "--output", o("pairs.txt"), "--zNear", "1", "--zFar", "4.5"],
        "rigTransform": ["--input", ti["cam0"], "--rig", ti["rig"], "--camera", "1", "--output", o("r.sfm")],
        "sfmToRig": ["--input", posed, "--output", o("rig.json")],
    }


def _files(folder):
    return {f: (folder / f).read_bytes() for f in sorted(os.listdir(folder))}


@pytest.mark.parametrize("name", ["sfmSplitReconstructed", "sfmMerge", "sfmMerge_aligned", "sfmTransfer",
                                  "applyCalibration", "sfmDistances", "sfmDistances_extent", "sfmRegression",
                                  "frustumFiltering", "rigTransform", "sfmToRig"])
def test_host_subcommands_match_reference(db, tool_inputs, tmp_path, name, capsys):
    outs, files = [], []
    for tag, main, extra in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
        os.makedirs(tmp_path / tag)
        argv = _host_commands(db, tool_inputs, lambda p: str(tmp_path / tag / p))[name]
        capsys.readouterr()
        assert main([name.split("_")[0], *argv, *extra]) == 0
        outs.append(capsys.readouterr().out)
        files.append(_files(tmp_path / tag))
    assert outs[0] == outs[1]
    assert files[0] == files[1]
    assert files[0] or outs[0]


def test_rig_calibration_and_sample_scene_match_reference(db, tool_inputs, tmp_path, capsys):
    outs = []
    for tag, main, extra in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
        capsys.readouterr()
        assert main(["rigCalibration", "--inputs", f"{tool_inputs['cam0']},{tool_inputs['cam1']}",
                     "--output", str(tmp_path / f"{tag}_rig.json"), *extra]) == 0
        assert main(["generateSampleScene", "--output", str(tmp_path / f"{tag}_g.sfm"), "--nbViews", "6",
                     "--nbPoints", "40", *extra]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    a, b = (json.loads((tmp_path / f"{t}_rig.json").read_text()) for t in ("jax", "port"))
    assert a["frames"] == b["frames"] == N_QUERIES
    for sa, sb in zip(a["subposes"], b["subposes"]):
        np.testing.assert_allclose(sb["R"], sa["R"], atol=1e-6)
        np.testing.assert_allclose(sb["c"], sa["c"], atol=1e-6)
    from alicevision_tpu import sfmdata as jsd

    ga, gb = jsd.load(str(tmp_path / "jax_g.sfm")), sfmdata.load(str(tmp_path / "port_g.sfm"))
    np.testing.assert_array_equal(gb.view_ids, ga.view_ids)
    np.testing.assert_allclose(gb.pose_R, ga.pose_R, atol=1e-6)
    np.testing.assert_allclose(gb.pose_c, ga.pose_c, atol=1e-6)
    assert gb.n_landmarks == ga.n_landmarks == 40


def test_subcommands_ported_count():
    ap = tcli.build_parser()
    sub = next(a for a in ap._actions if a.dest == "cmd").choices
    unported = [n for n, p in sub.items() if (p._defaults.get("_handler") or tcli._HANDLERS.get(n)) is None]
    assert len(sub) == 103 and unported == [] and not hasattr(cli_ext, "_not_ported")
    for name in ("cameraLocalization", "rigCalibration", "rigTransform", "rigLocalization", "sfmToRig",
                 "frustumFiltering", "sfmTransfer", "applyCalibration", "sfmDistances", "sfmRegression", "sfmMerge",
                 "sfmSplitReconstructed", "generateSampleScene"):
        assert name not in unported

