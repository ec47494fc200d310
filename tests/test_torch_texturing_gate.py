"""chip_smoke.py's texturing gate (`atlas_fills`, CLI_MIN_FOOTPRINT_FILL):
the share of the atlas's chart texels that the views coloured, read the
same way on the port's and the JAX package's textured OBJ of one scene
(`test_torch_mesh_post._texture_scene`, a 256² atlas), and a planted fault
(half of the atlas blacked out) that the gate reports.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from alicevision_tpu.mesh import uv_atlas as juv
from alicevision_tpu_torch.image.io import read_image, write_image
from alicevision_tpu_torch.mesh import uv_atlas as tuv
from test_torch_mesh_post import _texture_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def textured(tmp_path_factory):
    V, F, imgs, K, R, c, dms = _texture_scene()
    d = tmp_path_factory.mktemp("tex")
    tuv.generate_textured_mesh(V, F, imgs, K, R, c, str(d / "port.obj"), depth_maps=dms, atlas_size=256, device="cpu")
    juv.generate_textured_mesh(V, F, imgs, K, R, c, str(d / "jax.obj"), depth_maps=dms, atlas_size=256)
    return d, len(F)


def test_atlas_fills_read_the_charts_alike_in_both_packages(textured):
    d, n_faces = textured
    port, ref = chip_smoke.atlas_fills(str(d / "port.obj")), chip_smoke.atlas_fills(str(d / "jax.obj"))
    assert port["footprint_texels"] == ref["footprint_texels"] > n_faces
    # the footprint is a part of the atlas; the charts' texels are coloured
    assert port["atlas_fill"] < 1.0 and port["footprint_fill"] >= chip_smoke.CLI_MIN_FOOTPRINT_FILL
    assert abs(port["footprint_fill"] - ref["footprint_fill"]) < 1e-3
    assert abs(port["atlas_fill"] - ref["atlas_fill"]) < 1e-3


def test_footprint_gate_reports_a_half_black_atlas(textured, tmp_path):
    d, _ = textured
    atlas = read_image(str(d / "port_atlas.png"))
    atlas[:, : atlas.shape[1] // 2] = 0
    obj = tmp_path / "port.obj"
    obj.write_text((d / "port.obj").read_text())
    write_image(str(tmp_path / "port_atlas.png"), atlas)
    fills = chip_smoke.atlas_fills(str(obj))
    assert 0.0 < fills["footprint_fill"] < chip_smoke.CLI_MIN_FOOTPRINT_FILL
