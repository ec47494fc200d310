"""The port's CLI in a subprocess, as a farm runs it, on the CPU: an empty
range exits 0, a missing input exits non-zero with a `fatal` line and no
traceback, lidarMerging and importE57 (the last subcommands ported) run and
print their JSON, and without `--device cpu` on a machine with no card the
command fails with the no-CUDA message.

Split from tests/test_torch_cli.py (its scene and its subprocess runner)
so that the two files run on two test workers.
"""

import json
import os

import numpy as np
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
    from alicevision_tpu_torch.image.e57 import write_e57
    from alicevision_tpu_torch.mvs.lidar import save_cloud_ply

    pts = np.random.RandomState(0).randn(50, 3)
    write_e57(str(tmp_path / "scan.e57"), pts, pose=((1.0, 0.0, 0.0, 0.0), [1.0, 2.0, 3.0]))
    save_cloud_ply(str(tmp_path / "s1.ply"), pts * 2)
    with open(tmp_path / "set.json", "w") as f:
        json.dump([{"ply": "scan.e57"}, {"ply": "s1.ply", "origin": [0, 0, 1]}], f)
    r = _run("lidarMerging", "--input", str(tmp_path / "set.json"), "--output", str(tmp_path / "m.ply"), *CPU)
    assert r.returncode == 0 and json.loads(r.stdout) == {"points": 100, "scans": 2}, r.stderr
    assert "lidarMerging done" in r.stderr and "item 13" not in r.stderr
    r = _run("importE57", "--input", str(tmp_path / "scan.e57"), "--output", str(tmp_path / "e.json"), *CPU)
    assert r.returncode == 0 and json.loads(r.stdout) == {"scans": 1, "points": 50}, r.stderr
    assert os.path.exists(tmp_path / "e_scan0.ply")


def test_subprocess_needs_cuda_without_device_cpu(scene, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    root, sfm = scene
    r = _run("convertSfMFormat", "--input", sfm, "--output", str(tmp_path / "s.sfm"))
    assert r.returncode != 0 and "no CUDA device" in r.stderr and "Traceback" not in r.stderr
    assert not os.path.exists(tmp_path / "s.sfm")
    assert tcli.main(["hardwareResources"]) == 1
