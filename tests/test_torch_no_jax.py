"""The port imports neither JAX nor the JAX package, and chip_smoke.py
refuses to run without a CUDA device."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A subprocess, because tests/conftest.py has imported jax in this one.
_PROBE = r"""
import importlib, pkgutil, sys
import alicevision_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
wanted = {"geometry.rotations", "geometry.pose", "camera.models", "utils.synthetic",
          "sfm.ba", "sfm.local_ba", "numeric", "convert", "ops.sgm_kernel",
          "image.filtering", "image.io", "image.exr", "utils.sensor_db", "features.sift",
          "features.io", "matching.descriptor_matching", "matching.voctree",
          "multiview.epipolar", "robust.ransac", "robust.estimators", "pipeline.stages",
          "multiview.triangulation", "multiview.five_point", "multiview.resection", "tracks",
          "tracks.builder", "sfm.incremental", "pipeline.runner", "ops.guided_filter",
          "mvs.normals", "mvs.refine", "mvs.sharded", "utils.rendered", "native", "mesh.ops",
          "mesh.delaunay_graphcut", "mesh.texturing", "mesh", "mesh.clean", "mesh.lscm",
          "mesh.uv_atlas", "mesh.render", "mesh.denoise", "panorama", "panorama.compositing",
          "sfm.expansion", "sfm.alignment", "sfm.statistics", "sfmdata.export", "sfmdata.colorize",
          "geometry.gps", "pipeline.cli", "pipeline.cli_ext", "image.colorspace", "image.processing",
          "utils.lcp", "utils.dcp", "panorama.warping", "panorama.graphcut_seams", "hdr", "hdr.calibration",
          "hdr.merge", "sfm.global_sfm", "sfm.rotation_sfm", "lp", "lp.linfinity", "localization",
          "localization.localizer", "localization.voctree_localizer", "localization.marker_localizer",
          "features.markers", "misc", "misc.rig", "sfm.rig_sequence", "sfm.frustum", "sfm.transfer",
          "sfmdata.merge", "camera.undistortion", "camera.convert", "calibration", "calibration.checkerboard",
          "calibration.zhang", "calibration.distortion_lines", "misc.color_checker", "misc.sphere_detection",
          "photometric", "photometric.stereo", "photometric.lighting", "photometric.light_calibration",
          "utils.calibration_scenes", "utils.svg", "sfmdata.middlebury", "sfmdata.alembic", "image.cache",
          "image.feeds", "matching.photometric_filter", "matching.kvld", "matching.hgrowing", "features.akaze",
          "keyframe", "keyframe.selector", "utils.onnx_rt", "misc.segmentation", "misc.masking",
          "misc.color_harmonization", "mvs.lidar", "image.e57", "utils.render", "system", "parallel",
          "parallel.mesh", "parallel.distributed", "parallel.ba_sharded", "parallel.comms_report",
          "parallel.launch", "image.jpeg", "image.exif", "image.tiff", "image.png", "image.bmp",
          "image.avi"}
missing = wanted - {n.split(".", 1)[1] for n in names}
assert not missing, missing
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "alicevision_tpu" or m.startswith("alicevision_tpu."))
print(len(names), "modules")
assert not bad, bad
"""


def test_port_and_chip_smoke_import_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 90  # every module of the slices


def test_chip_smoke_needs_cuda():
    import chip_smoke

    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        chip_smoke.main([])
