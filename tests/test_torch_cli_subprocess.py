"""The port's CLI in a subprocess, as a farm runs it, on the CPU: an empty
range exits 0, a missing input exits non-zero with a `fatal` line and no
traceback, an unported subcommand exits 1 naming ROADMAP item 13, and
without `--device cpu` on a machine with no card the command fails with the
no-CUDA message.

Split from tests/test_torch_cli.py (its scene and its subprocess runner)
so that the two files run on two test workers.
"""

import os

import pytest
import torch

from alicevision_tpu_torch.pipeline import cli as tcli
from test_torch_cli import CPU, _run, scene  # noqa: F401 (scene is a module fixture)

torch.set_num_threads(1)


def test_subprocess_contract(scene, tmp_path):
    root, sfm = scene
    r = _run("featureExtraction", "--input", sfm, "--output", str(tmp_path / "f"), "--rangeStart", "999",
             "--rangeSize", "10", *CPU)
    assert r.returncode == 0, r.stderr
    assert "featureExtraction done" in r.stderr
    r = _run("featureExtraction", "--input", str(tmp_path / "nope.sfm"), "--output", str(tmp_path / "x"), *CPU)
    assert r.returncode != 0 and "fatal" in r.stderr.lower() and "Traceback" not in r.stderr
    r = _run("lidarMerging", "--input", str(tmp_path / "set.json"), "--output", str(tmp_path / "m.ply"), *CPU)
    assert r.returncode == 1 and "ROADMAP item 13" in r.stderr and "Traceback" not in r.stderr
    r = _run("importE57", "--input", str(tmp_path / "scan.e57"), "--output", str(tmp_path / "e"), *CPU)
    assert r.returncode == 1 and "ROADMAP item 13" in r.stderr


def test_subprocess_needs_cuda_without_device_cpu(scene, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    root, sfm = scene
    r = _run("convertSfMFormat", "--input", sfm, "--output", str(tmp_path / "s.sfm"))
    assert r.returncode != 0 and "no CUDA device" in r.stderr and "Traceback" not in r.stderr
    assert not os.path.exists(tmp_path / "s.sfm")
    assert tcli.main(["hardwareResources"]) == 1
