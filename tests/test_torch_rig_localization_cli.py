"""The port's rigLocalization subcommand against the JAX CLI's on the CPU,
on tests/test_torch_camera_localization_cli.py's database, queries and rig
(the rig's second camera at its true sub-pose), with its tolerances.

Split from that file so that the two run on two test workers; each CLI
runs its own SIFT, vocabulary tree and RANSAC draws, so the two agree in
what each frame gives: the same success flags, printed JSON and JSON
layout, inlier counts within 25 % (at least 3), poses within 1 deg and
1 % of the ring's radius. The average fusion localizes each camera at the
CLI's defaults and maps it through the sub-pose.
"""

import json

import pytest
import torch

from test_torch_camera_localization_cli import (  # noqa: F401 (fixtures)
    _assert_agree,
    _jitted_reference_sift_and_bow,
    _run_both,
    queries,
)
from test_torch_localization import _jitted_reference_resection  # noqa: F401 (an autouse fixture)
from test_torch_localization_cli import db  # noqa: F401 (a fixture)

torch.set_num_threads(1)


@pytest.mark.parametrize("fusion", ["joint", "average"])
def test_rig_localization_matches_reference(db, queries, tmp_path, capsys, fusion):
    feats = db[2]
    inputs, rig, sfm = queries
    argv = ["rigLocalization", "--input", sfm, "--features", feats, "--queryFolders", ",".join(inputs["folders"]),
            "--rig", rig, "--fusion", fusion]
    printed, written = _run_both(argv, "rig.json", tmp_path, capsys)
    assert printed["port"] == printed["jax"]
    _assert_agree(written["jax"], written["port"], ["n_inliers", "cameras"])
    assert all(r["success"] for r in written["jax"].values())
    if fusion == "average":
        # each camera's own file, as the JAX CLI writes it
        for k in range(2):
            a, b = (json.loads((tmp_path / f"{t}_rig.json.cam{k}.json").read_text()) for t in ("jax", "port"))
            _assert_agree(a, b, ["n_inliers"])
