"""The port's cameraLocalization subcommand against the JAX CLI's on the CPU,
on the same database and query folders (rigLocalization on the same inputs:
tests/test_torch_rig_localization_cli.py).

The database is tests/test_torch_localization_cli.py's (the hard scene's
40-view ring rendered undistorted at 320x240, landmarks triangulated at the
true poses); the queries are chip_smoke's localization queries at that size
(between ring views, and the rig's second camera at its sub-pose), and the
rig file holds the true sub-pose. Each CLI runs its own SIFT (JAX's compiles
once for the module), vocabulary tree and RANSAC draws, so the two agree in
what each query gives, not bit for bit: the same success flags, printed
JSON and JSON layout, inlier counts within 25 % (at least 3) of each other,
and poses within 1 deg and 1 % of the ring's radius of each other (the
readings: up to 0.58 deg, 0.75 %, inliers 8 apart). One run decimates its
queries (`--downscaleTo 300`: every other pixel, keypoints scaled back by
2; two of the four localize from 14-18 inliers, 1.6 deg and 2.0 % apart):
3 deg and 4 % there. JAX's robust P3P (tests/test_torch_localization.py's
fixture), its query SIFT and its bags of words are jitted for the module.
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from alicevision_tpu.pipeline import cli as jcli
from alicevision_tpu_torch.pipeline import cli as tcli
from test_torch_localization import _jitted_reference_resection  # noqa: F401 (an autouse fixture)
from test_torch_localization_cli import CPU, FOCAL, N_QUERIES, WH, db  # noqa: F401 (db is a fixture)

torch.set_num_threads(1)

RADIUS = 6.0
INLIER_RTOL, INLIER_ATOL = 0.25, 3
TOL = (1.0, 0.01)  # deg, fraction of the radius
TOL_DECIMATED = (3.0, 0.04)  # 160x120 queries: 14-18 inliers a pose


@pytest.fixture(scope="module", autouse=True)
def _jitted_reference_sift_and_bow():
    """The JAX CLI's query SIFT and its localizer's bags of words, jitted
    once a shape for the module: they run eagerly inside the JAX CLI,
    compiling every primitive of every shape (most of the file's time)."""
    import jax

    from alicevision_tpu.features import sift as jsift
    from alicevision_tpu.localization import voctree_localizer as jvl
    from alicevision_tpu.matching import voctree as jvt

    extract = jax.jit(jsift.extract, static_argnums=1)
    bow = jax.jit(lambda c, d, v, nc, nl: jvt.bow_vector(jvt.VocTree(c, nc, nl), d, v), static_argnums=(3, 4))
    mp = pytest.MonkeyPatch()
    mp.setattr(jsift, "extract", extract)
    mp.setattr(jvl, "bow_vector", lambda tree, d, v: bow(tree.centers, d, v, tree.n_children, tree.n_levels))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def queries(db, tmp_path_factory):
    """(chip_smoke.make_localization_inputs at the test size, rig .json
    with the true sub-pose, the database with its observations' feature
    ids: `chip_smoke.with_feature_ids`, as the phase localizes)."""
    work = str(tmp_path_factory.mktemp("locq"))
    sfm = os.path.join(work, "database.sfm")
    assert chip_smoke.with_feature_ids(db[1], db[2], sfm) == 0
    inputs = chip_smoke.make_localization_inputs(work, "cpu", N_QUERIES, WH, FOCAL, (0.0, 0.0, 0.0))
    p = inputs["poses"]
    rig = os.path.join(work, "rig.json")
    with open(rig, "w") as f:
        json.dump({"subposes": [{"R": np.eye(3).tolist(), "c": [0.0, 0.0, 0.0]},
                                {"R": p["sub_R"].tolist(), "c": p["sub_c"].tolist()}], "frames": N_QUERIES}, f)
    return inputs, rig, sfm


def _run_both(argv, out_name, tmp_path, capsys):
    """argv through the JAX CLI and the port's (--device cpu), each writing
    --output <tag>_<out_name>: ({tag: printed JSON}, {tag: output JSON})."""
    printed, written = {}, {}
    for tag, main, extra in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
        out = str(tmp_path / f"{tag}_{out_name}")
        capsys.readouterr()
        assert main([*argv, "--output", out, *extra]) == 0
        printed[tag] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        with open(out) as f:
            written[tag] = json.load(f)
    return printed, written


def _angle_deg(R):
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))))


def _assert_agree(ref: dict, port: dict, localized_keys, tol=TOL):
    assert list(port) == list(ref)
    for name, a in ref.items():
        b = port[name]
        assert set(b) == set(a) and b["success"] == a["success"], (name, a, b)
        for key in localized_keys:
            if key in a:
                assert b[key] == a[key] if key == "cameras" else abs(b[key] - a[key]) <= max(
                    INLIER_ATOL, INLIER_RTOL * a[key]), (name, key, a[key], b[key])
        if a["success"]:
            assert _angle_deg(np.asarray(b["R"]) @ np.asarray(a["R"]).T) < tol[0], name
            assert np.linalg.norm(np.asarray(b["c"]) - np.asarray(a["c"])) < tol[1] * RADIUS, name


@pytest.mark.parametrize("method,downscale", [("voctree", None), ("direct", None)])
def test_camera_localization_matches_reference(db, queries, tmp_path, capsys, method, downscale):
    check_camera_localization(db, queries, tmp_path, capsys, method, downscale)


def check_camera_localization(db, queries, tmp_path, capsys, method, downscale):
    """One cameraLocalization run through both CLIs, held together (the
    decimated run: tests/test_torch_camera_localization_decimated_cli.py)."""
    feats = db[2]
    inputs, _, sfm = queries
    argv = ["cameraLocalization", "--input", sfm, "--features", feats, "--queryFolder", inputs["folders"][0],
            "--method", method, *([] if downscale is None else ["--downscaleTo", str(downscale)])]
    printed, written = _run_both(argv, "loc.json", tmp_path, capsys)
    assert printed["port"] == printed["jax"]
    _assert_agree(written["jax"], written["port"], ["n_inliers"], TOL if downscale is None else TOL_DECIMATED)
    if downscale is None:
        # at full resolution every query localizes in both
        assert printed["jax"] == {"localized": N_QUERIES, "total": N_QUERIES}
