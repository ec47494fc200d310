"""The port's calibration, distortion, colour-chart and photometric
subcommands (`pipeline/cli_ext.py`, `cli.py`'s checkerboardCalibration)
against the JAX CLI on the CPU, and a CPU run of chip_smoke.py's
`calibration` phase at a small size with its gates.

The JAX CLI runs the phase's chain (`chip_smoke.run_calibration_chain`)
once on small shoots (`utils/calibration_scenes.py`: 4 board frames at
480x360, a chart at 400x260, a sphere and a relief under 6 lights at
160x120). Each port subcommand then reads the JAX chain's inputs for that
step, so the two outputs are compared on the same files: host code (the
chart, the sphere, the Nuke text) byte for byte, corner grids within 1e-3
px, K within rtol 1e-4, fitted distortion by the field it gives out to the
farthest corner (within 0.05 px: k1..k3 trade off on 4 frames, and the
port solves its normal equations in float64), maps within 1e-5, normals
within 1e-5, the CG depth within 1e-4 of its range, SH lighting by the
shading it renders (the port forms its 9x9 normal equations in float64).
"""

import contextlib
import copy
import io
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from alicevision_tpu.pipeline import cli as jcli
from alicevision_tpu_torch import sfmdata
from alicevision_tpu_torch.photometric import render_sh
from alicevision_tpu_torch.pipeline import cli as tcli

torch.set_num_threads(1)

BOARD = dict(n_frames=4, rows=4, cols=6, wh=(480, 360), focal_px=420.0, k1=-0.1)
CHART = dict(wh=(400, 260), patch=40, gap=10)
PHOTO = dict(wh=(160, 120), n_lights=6, sphere_r=30.0)


def _quiet(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    text = out.getvalue().strip()
    return rc, json.loads(text.splitlines()[-1]) if text.startswith("{") else None


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """(JAX work dir, inputs, {subcommand: argv}, {subcommand: printed JSON})."""
    work = str(tmp_path_factory.mktemp("calref"))
    inputs = chip_smoke.make_calibration_inputs(work, BOARD, CHART, PHOTO)
    printed = {}

    def main(argv):
        rc, printed[argv[0]] = _quiet(jcli.main, argv)
        return rc

    chip_smoke.run_calibration_chain(main, work, inputs)
    with open(os.path.join(work, "sphere.json")) as f:
        sphere = json.load(f)["sphere"]
    first, photometric = chip_smoke.calibration_chains(work, inputs)
    return work, inputs, dict(first + photometric(sphere)), printed


def port_run(chain, name, out_dir, extra=()):
    """The port's `name` on the JAX chain's inputs, its outputs in out_dir
    (the file or folder after --output). Returns (its output path, the JSON
    it printed)."""
    work, _, argv, _ = chain
    argv = list(argv[name]) + list(extra)
    i = argv.index("--output")
    out = os.path.join(str(out_dir), os.path.relpath(argv[i + 1], work))
    argv[i + 1] = out
    rc, printed = _quiet(tcli.main, [name, *argv, "--device", "cpu"])
    assert rc == 0
    return out, printed


def ref_path(chain, name):
    argv = chain[2][name]
    return argv[argv.index("--output") + 1]


def load_json(path):
    with open(path) as f:
        return json.load(f)


def _field_px(chain, dk, K):
    """The largest displacement, in px, of radial coefficients dk (k1, k2,
    ...) out to the farthest detected corner: coefficients that trade off
    are compared by the field they give where the data is."""
    f, c = K[0][0], np.array([K[0][2], K[1][2]])
    uv = np.concatenate([np.asarray(v) for v in load_json(os.path.join(chain[0], "corners.json"))["detections"]
                         .values()])
    r = np.linspace(0.0, np.linalg.norm((uv - c) / f, axis=-1).max(), 200)
    return float(np.abs(f * r * sum(k * r ** (2 * i + 2) for i, k in enumerate(dk))).max())


def test_checkerboard_detection_matches(chain, tmp_path):
    out, printed = port_run(chain, "checkerboardDetection", tmp_path)
    got, want = load_json(out), load_json(ref_path(chain, "checkerboardDetection"))
    assert printed == chain[3]["checkerboardDetection"] == {"detected": BOARD["n_frames"], "images": BOARD["n_frames"]}
    assert (got["rows"], got["cols"]) == (want["rows"], want["cols"]) and set(got["detections"]) == set(
        want["detections"])
    for k in want["detections"]:
        np.testing.assert_allclose(got["detections"][k], want["detections"][k], atol=1e-3)


@pytest.mark.parametrize("name", ["checkerboardCalibration", "cameraCalibration"])
def test_calibration_commands_match(chain, tmp_path, name):
    out, printed = port_run(chain, name, tmp_path)
    got, want = load_json(out), load_json(ref_path(chain, name))
    np.testing.assert_allclose(got["K"], want["K"], rtol=1e-4)
    # k1 and k2 trade off on 4 frames: held by the displacement they give
    # out to the farthest corner seen (the float32 and float64 normal
    # equations land on different pairs of one field)
    assert _field_px(chain, np.subtract(got["dist"], want["dist"]), want["K"]) < 0.05, (got["dist"], want["dist"])
    assert abs(got["rms"] - want["rms"]) < 1e-4 and got["n_views"] == want["n_views"] == BOARD["n_frames"]
    if name == "cameraCalibration":
        assert printed["views"] == chain[3][name]["views"] and abs(printed["rms"] - chain[3][name]["rms"]) < 1e-4


def test_convert_and_export_distortion_match(chain, tmp_path):
    out, printed = port_run(chain, "convertDistortion", tmp_path)
    assert printed == chain[3]["convertDistortion"] == {"intrinsics": 1, "to": "brown"}
    got, want = sfmdata.load(out), sfmdata.load(ref_path(chain, "convertDistortion"))
    assert np.array_equal(got.disto_kind, want.disto_kind)
    np.testing.assert_allclose(got.disto, want.disto, atol=1e-5)
    assert np.array_equal(got.scale, want.scale) and np.array_equal(got.offset, want.offset)
    out, printed = port_run(chain, "exportDistortion", tmp_path)
    ref = ref_path(chain, "exportDistortion")
    assert printed == chain[3]["exportDistortion"] and sorted(os.listdir(out)) == sorted(os.listdir(ref))
    for f in os.listdir(ref):
        if f.endswith(".npy"):
            np.testing.assert_allclose(np.load(os.path.join(out, f)), np.load(os.path.join(ref, f)), atol=1e-5)
        else:
            with open(os.path.join(out, f)) as a, open(os.path.join(ref, f)) as b:
                assert a.read() == b.read()


@pytest.mark.parametrize("model", ["none", "3declassicld"])
def test_distortion_calibration_matches(chain, tmp_path, model):
    extra = () if model == "none" else ("--undistortionModelName", model)
    out, printed = port_run(chain, "distortionCalibration", tmp_path, extra)
    if model == "none":
        want_sc, want_printed = sfmdata.load(ref_path(chain, "distortionCalibration")), chain[3]["distortionCalibration"]
    else:
        ref = str(tmp_path / "ref_3de.sfm")
        argv = list(chain[2]["distortionCalibration"])
        argv[argv.index("--output") + 1] = ref
        _, want_printed = _quiet(jcli.main, ["distortionCalibration", *argv, *extra])
        want_sc = sfmdata.load(ref)
    got = sfmdata.load(out)
    assert np.array_equal(got.disto_kind, want_sc.disto_kind)
    # k1..k3 trade off on 4 frames' lines: held by their field
    K = load_json(os.path.join(chain[0], "calib.json"))["K"]
    assert _field_px(chain, got.disto[0, :3] - want_sc.disto[0, :3], K) < 0.05, (got.disto, want_sc.disto)
    if model != "none":
        from alicevision_tpu_torch.camera import undistortion as und

        g, w = got.intrinsic_extra[0]["undistortion"], want_sc.intrinsic_extra[0]["undistortion"]
        assert g["type"] == w["type"] == model and g["diagonal"] == w["diagonal"]
        # the 3DE model's 5 parameters trade off too: held by its warp of the corners
        uv = np.concatenate([np.asarray(v) for v in load_json(os.path.join(chain[0], "corners.json"))["detections"]
                             .values()])
        warped = [und.undistort_pixels(und.scene_undistortion(sc, 0), uv, device="cpu").numpy() for sc in (got, want_sc)]
        assert np.abs(warped[0] - warped[1]).max() < 0.05
    for k in ("rms_before", "rms_after"):
        assert abs(printed[k] - want_printed[k]) < 1e-3 * max(1.0, want_printed[k])


def test_color_checker_commands_match(chain, tmp_path):
    out, printed = port_run(chain, "colorCheckerDetection", tmp_path)
    assert printed == chain[3]["colorCheckerDetection"] == {"detected": 1}
    assert load_json(out) == load_json(ref_path(chain, "colorCheckerDetection"))
    out, printed = port_run(chain, "colorCheckerCorrection", tmp_path)
    ref = ref_path(chain, "colorCheckerCorrection")
    assert printed == chain[3]["colorCheckerCorrection"] and os.listdir(out) == os.listdir(ref)
    for f in os.listdir(ref):
        assert np.array_equal(np.load(os.path.join(out, f)), np.load(os.path.join(ref, f)))


def test_sphere_and_lighting_calibration_match(chain, tmp_path):
    out, printed = port_run(chain, "sphereDetection", tmp_path)
    assert printed == chain[3]["sphereDetection"] == {"found": True}
    assert load_json(out) == load_json(ref_path(chain, "sphereDetection"))
    out, printed = port_run(chain, "lightingCalibration", tmp_path)
    assert printed == chain[3]["lightingCalibration"] == {"lights": PHOTO["n_lights"]}
    np.testing.assert_allclose(load_json(out)["directions"], load_json(ref_path(chain, "lightingCalibration"))
                               ["directions"], atol=1e-6)
    # without --sphere each image's sphere is detected
    argv = [a for i, a in enumerate(chain[2]["lightingCalibration"])
            if a != "--sphere" and chain[2]["lightingCalibration"][i - 1] != "--sphere"]
    outs = []
    for main, extra in ((jcli.main, ()), (tcli.main, ("--device", "cpu"))):
        argv[argv.index("--output") + 1] = str(tmp_path / f"auto_{len(outs)}.json")
        assert _quiet(main, ["lightingCalibration", *argv, *extra])[0] == 0
        outs.append(load_json(argv[argv.index("--output") + 1])["directions"])
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-6)


@pytest.mark.parametrize("lights", ["json", "npy"])
def test_photometric_stereo_matches(chain, tmp_path, lights):
    extra = ("--integrate",) if lights == "npy" else ()
    argv = chain[2]["photometricStereo"]
    if lights == "npy":
        path = str(tmp_path / "lights.npy")
        np.save(path, np.asarray(load_json(argv[argv.index("--lights") + 1])["directions"]))
        chain = (chain[0], chain[1], {**chain[2], "photometricStereo": [
            path if i == argv.index("--lights") + 1 else a for i, a in enumerate(argv)]}, chain[3])
    out, printed = port_run(chain, "photometricStereo", tmp_path, extra)
    assert printed == {"images": PHOTO["n_lights"]}
    ref = ref_path(chain, "photometricStereo")
    for f in ("normals.npy", "albedo.npy"):
        np.testing.assert_allclose(np.load(os.path.join(out, f)), np.load(os.path.join(ref, f)), atol=1e-5)
    if lights == "npy":
        z = np.load(os.path.join(out, "depth.npy"))
        z_ref = np.load(os.path.join(chain[0], "ps", "depth.npy"))
        assert np.abs(z - z_ref).max() < 1e-4 * np.ptp(z_ref)


def test_normal_integration_and_lighting_estimation_match(chain, tmp_path):
    out, _ = port_run(chain, "normalIntegration", tmp_path)
    z_ref = np.load(ref_path(chain, "normalIntegration"))
    z = np.load(out)
    assert z.shape == z_ref.shape and np.abs(z - z_ref).max() < 1e-4 * np.ptp(z_ref)
    work = chain[0]
    n = torch.as_tensor(np.load(os.path.join(work, "ps", "normals.npy")), dtype=torch.float64)
    albedo = np.load(os.path.join(work, "ps", "albedo.npy"))
    for with_albedo in (True, False):
        argv = list(chain[2]["lightingEstimation"])
        if not with_albedo:
            i = argv.index("--albedo")
            del argv[i:i + 2]
        ref = str(tmp_path / f"sh_ref_{with_albedo}.json")
        argv[argv.index("--output") + 1] = ref
        rc, want_printed = _quiet(jcli.main, ["lightingEstimation", *argv])
        chain_k = (chain[0], chain[1], {**chain[2], "lightingEstimation": argv}, chain[3])
        out, printed = port_run(chain_k, "lightingEstimation", tmp_path / f"port_{with_albedo}")
        assert rc == 0 and printed == want_printed == {"sh_dim": 9}
        a = albedo if with_albedo else 1.0
        shade = [render_sh(n, torch.as_tensor(load_json(p)["sh"], dtype=torch.float64)).numpy() * a for p in (out, ref)]
        img = np.load(argv[argv.index("--image") + 1])
        err = [np.abs(s - img).mean() for s in shade]
        assert err[0] <= err[1] * 1.01 + 1e-6, err


def test_calibration_subcommands_run():
    """All 103 subcommands have a handler; none is a stub."""
    from alicevision_tpu_torch.pipeline import cli_ext

    sub = next(a for a in tcli.build_parser()._actions if a.dest == "cmd").choices
    unported = [n for n, p in sub.items() if (p._defaults.get("_handler") or tcli._HANDLERS.get(n)) is None]
    assert len(sub) == 103 and unported == [] and not hasattr(cli_ext, "_not_ported")
    for name in ("checkerboardDetection", "cameraCalibration", "distortionCalibration", "convertDistortion",
                 "exportDistortion", "photometricStereo", "normalIntegration", "lightingEstimation",
                 "lightingCalibration", "sphereDetection", "colorCheckerDetection", "colorCheckerCorrection",
                 "checkerboardCalibration",
                 # the front-end extras and the exports
                 "voctreeCreation", "computeUncertainty", "voctreeQueryUtility", "voctreeStatistics",
                 "exportMVSTexturing", "exportMatlab", "exportMeshroomMaya", "exportKeypoints", "exportMatches",
                 "exportTracks", "importMiddlebury", "keyframeSelection"):
        assert name not in unported


@pytest.fixture(scope="module")
def phase(chain, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("calphase"))
    return chip_smoke.run_calibration_phase("cpu", work, board_cfg=BOARD, chart_cfg=CHART, photo_cfg=PHOTO)


def test_chip_smoke_calibration_phase_on_cpu(phase):
    rep = phase["report"]
    assert rep["frames_detected"] == BOARD["n_frames"] and rep["corner_err_px_median"] < 0.5
    assert rep["camera"]["focal_err_frac"] < 0.01 and rep["camera"]["views"] == BOARD["n_frames"]
    assert rep["chart_found"] and rep["chart_residual"] < 0.01 and rep["lights"] == PHOTO["n_lights"]
    assert rep["normal_err_deg_median"] < 5.0 and not any(phase["sgm_launches"].values())
    assert phase["card_cpu"]["K_rel_diff"] == 0.0 and phase["card_cpu"]["normal_diff_deg_max"] < 1e-4
    assert set(phase["commands"]) == {n for n, _ in chip_smoke.calibration_chains(
        "w", {"folders": dict.fromkeys(("board", "chart", "ps_sphere", "ps_object"), "f"), "board": BOARD,
              "cfg": {"photo": PHOTO}})[0]} | {"lightingCalibration", "photometricStereo", "normalIntegration",
                                               "lightingEstimation"}


# the JAX chain's readings at the phase's size (calibration_chain_reference.py)
RECORDED = {
    "frames_detected": 15, "corner_err_px_median": 0.12711865092008182,
    "camera": {"focal_err_frac": 6.404622395833333e-05, "pp_err_px": 0.28242423055254773,
               "rms_px": 0.11319755017757416, "k1_err": 0.0011471313238143876, "views": 15},
    "brown_kind": 3, "brown_k_diff": 5.9159539489428425e-08, "lines_k": [-0.11990, 0.01426, -0.05994],
    "lines_k1_err": 9.787350893020186e-05, "stmap_err_px_median": 0.031616764534515784, "chart_found": True,
    "chart_centre_err_px_median": 0.7071067811865476, "chart_residual": 0.00026023038500647805,
    "sphere": [1126, 737, 300], "sphere_err_px": 0.488262224629407, "sphere_r_err_px": 0.0, "lights": 12,
    "light_err_deg_max": 0.7729508216585363, "normal_err_deg_median": 0.474337432260467,
    "depth_err_px_median": 19.942389518211154, "sh_residual": 0.006720091390424827,
}


def _recorded_row():
    rep = copy.deepcopy(RECORDED)
    rep["board"] = copy.deepcopy(rep["camera"])
    return {"report": rep, "card_cpu": {"K_rel_diff": 0.0, "normal_diff_deg_max": 1.2e-6},
            "sgm_launches": {"sgm_directional_pass": 0, "sgm_axis_sweeps": 0}}


def test_calibration_gates_pass_the_recorded_readings_and_report_planted_faults():
    assert chip_smoke.calibration_misses(_recorded_row()) == []

    def planted(edit):
        row = _recorded_row()
        edit(row)
        return [b.split(":")[0] for b in chip_smoke.calibration_misses(row)]

    def focal_off(row):  # a recovered focal 2 % off
        row["report"]["camera"]["focal_err_frac"] = 0.02

    def agree(row):  # the card's normals parting from the CPU's
        row["card_cpu"]["normal_diff_deg_max"] = 0.5

    def lost_frame(row):
        row["report"]["frames_detected"] = 14

    assert planted(focal_off) == ["camera calibration"]
    assert planted(agree) == ["the card against the CPU"]
    assert planted(lost_frame) == ["checkerboardDetection"]


def test_eigh_site_gates_report_a_planted_disagreement():
    rows = {name: {"valid": 0.9, "valid_cpu": 0.9, "card_cpu_agree": 1.0} for name in chip_smoke.EIGH_SITE_TOL}
    assert chip_smoke.eigh_site_misses(rows) == []
    bad = copy.deepcopy(rows)
    bad["essential_5pt"]["card_cpu_agree"] = 0.97
    bad["triangulate_dlt"]["valid"] = 0.85
    assert [b.split(":")[0] for b in chip_smoke.eigh_site_misses(bad)] == ["essential_5pt", "triangulate_dlt"]
