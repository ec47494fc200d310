"""The port's cameraLocalization against the JAX CLI's on the CPU with its
queries decimated (`--downscaleTo 300`: every other pixel, keypoints
scaled back by 2; two of the four localize from 14-18 inliers, 1.6 deg
and 2.0 % apart): flags and printed JSON equal, inliers within 25 %, poses
within 3 deg and 4 % of the radius.

tests/test_torch_camera_localization_cli.py's database, queries, jitted
JAX references and check, in a file of its own so that the run starts
early on its own test worker.
"""

import pytest
import torch

from test_torch_camera_localization_cli import (  # noqa: F401 (fixtures)
    _jitted_reference_sift_and_bow,
    check_camera_localization,
    queries,
)
from test_torch_localization import _jitted_reference_resection  # noqa: F401 (an autouse fixture)
from test_torch_localization_cli import db  # noqa: F401 (a fixture)

torch.set_num_threads(1)


@pytest.mark.parametrize("method,downscale", [("direct", 300)])
def test_camera_localization_matches_reference(db, queries, tmp_path, capsys, method, downscale):  # noqa: F811
    check_camera_localization(db, queries, tmp_path, capsys, method, downscale)
