"""The port's scene IO, state carriers, camera model and depth lists against
the JAX reference, on the CPU."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu import camera as jcam
from alicevision_tpu import sfmdata as jsfm
from alicevision_tpu.mvs import depth_list as jdl
from alicevision_tpu.mvs.plane_sweep import SgmParams as JSgmParams
from alicevision_tpu.utils.rendered import render_views
from alicevision_tpu_torch import camera as tcam
from alicevision_tpu_torch import sfmdata as tsfm
from alicevision_tpu_torch.convert import scene_from_reference, sgm_params_from_reference
from alicevision_tpu_torch.mvs import depth_list as tdl
from alicevision_tpu_torch.mvs.plane_sweep import SgmParams as TSgmParams

torch.set_num_threads(1)


def _reference_scene():
    """A JAX-package scene: two intrinsics (radial K3, Brown), four posed
    views and one unposed, landmarks with observations."""
    _, _, K, R, c = render_views(n_views=4, wh=(80, 60), focal_px=70.0, arc=0.4)
    sc = jsfm.SfMData.empty()
    sc.add_intrinsic(10, 80, 60, 70.0, disto_kind=jcam.DISTO_RADIALK3,
                     disto_params=(-0.1, 0.02, -0.003), offset=(0.3, -0.2))
    sc.add_intrinsic(11, 80, 60, 72.0, disto_kind=jcam.DISTO_BROWN,
                     disto_params=(0.05, -0.01, 0.002, 1e-3, -2e-3), focal_y_px=71.0)
    for v in range(5):
        vi = sc.add_view(100 + v, v % 2, 80, 60, path=f"/data/img{v}.npy",
                         metadata={"Make": "test"} if v == 0 else None)
        if v < 4:
            sc.set_pose(vi, R[v], c[v])
    rng = np.random.RandomState(0)
    pts = rng.randn(20, 3)
    obs_lm = np.repeat(np.arange(20), 2)
    obs_view = np.tile([0, 2], 20)
    sc.set_structure(pts, obs_lm, obs_view, rng.rand(40, 2) * 60,
                     obs_scale=rng.rand(40), colors=rng.randint(0, 255, (20, 3)).astype(np.uint8))
    return sc


FIELDS = [f.name for f in dataclasses.fields(jsfm.SfMData)]


def _assert_same_scene(a, b):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(np.asarray(y), x, err_msg=name)
        else:
            assert len(x) == len(y), name


def test_sfm_written_by_reference_loads_in_port(tmp_path):
    sc = _reference_scene()
    path = str(tmp_path / "ref.sfm")
    jsfm.save(sc, path)
    _assert_same_scene(jsfm.load(path), tsfm.load(path))


def test_sfm_written_by_port_loads_in_reference(tmp_path):
    sc = scene_from_reference(dataclasses.asdict(_reference_scene()))
    path = str(tmp_path / "port.sfm")
    tsfm.save(sc, path)
    back = jsfm.load(path)
    _assert_same_scene(tsfm.load(path), back)
    _assert_same_scene(sc, back)


def test_scene_from_reference_round_trips():
    ref = _reference_scene()
    port = scene_from_reference(dataclasses.asdict(ref))
    _assert_same_scene(ref, port)
    assert port.view_metadata == ref.view_metadata
    port.points[0, 0] = 1e9  # a copy, not a view
    assert ref.points[0, 0] != 1e9
    again = jsfm.SfMData(**dataclasses.asdict(scene_from_reference(dataclasses.asdict(ref))))
    _assert_same_scene(ref, again)
    np.testing.assert_array_equal(port.valid_views(), ref.valid_views())
    with pytest.raises(ValueError):
        scene_from_reference({"view_ids": np.zeros(0)})


def test_sgm_params_round_trip():
    ref = JSgmParams(n_depths=64, p1=7.5, method="gather", n_dirs=8)
    port = sgm_params_from_reference(ref._asdict())
    assert isinstance(port, TSgmParams) and port._asdict() == ref._asdict()
    assert JSgmParams(**port._asdict()) == ref
    assert TSgmParams()._asdict() == JSgmParams()._asdict()  # same defaults
    with pytest.raises(ValueError):
        sgm_params_from_reference({"n_depth": 3})


def test_other_scene_formats_raise(tmp_path):
    """An unknown extension raises; Alembic is ported (a host copy): the
    port writes the JAX package's bytes and reads its archive back; PLY and
    BAF exports write (their bytes are held to the JAX package's in
    tests/test_torch_exports.py)."""
    sc = tsfm.SfMData.empty()
    for ext in (".xyz", ".abcd"):
        with pytest.raises(ValueError, match="unsupported"):
            tsfm.save(sc, str(tmp_path / f"s{ext}"))
        with pytest.raises(ValueError, match="unsupported"):
            tsfm.load(str(tmp_path / f"s{ext}"))
    for ext in (".ply", ".baf"):
        tsfm.save(sc, str(tmp_path / f"s{ext}"))
        assert os.path.getsize(tmp_path / f"s{ext}") > 0
    jsfm.save(_reference_scene(), str(tmp_path / "r.sfm"))
    jsfm.save(jsfm.load(str(tmp_path / "r.sfm")), str(tmp_path / "j.abc"))
    tsfm.save(tsfm.load(str(tmp_path / "r.sfm")), str(tmp_path / "t.abc"))
    assert (tmp_path / "t.abc").read_bytes() == (tmp_path / "j.abc").read_bytes()
    a, b = jsfm.load(str(tmp_path / "j.abc")), tsfm.load(str(tmp_path / "j.abc"))
    for field in ("view_ids", "view_pose", "pose_R", "pose_c", "points", "obs_uv", "scale", "offset", "disto"):
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field))


def test_intrinsics_table_matches():
    sc = _reference_scene()
    ref = sc.intrinsics_table()
    out = scene_from_reference(dataclasses.asdict(sc)).intrinsics_table()
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("row", [0, 1], ids=["radialk3", "brown"])
def test_distortion_and_pixel_maps_match(row):
    sc = _reference_scene()
    ji = jcam.Intrinsics(*[jnp.asarray(np.asarray(x)[row]) for x in sc.intrinsics_table()])
    ti = scene_from_reference(dataclasses.asdict(sc)).intrinsics_table().row(row)
    pix = (np.random.RandomState(2).rand(200, 2) * [80, 60]).astype(np.float32)
    pj = jcam.ima2cam(ji, jnp.asarray(pix))
    pt = tcam.ima2cam(ti, torch.from_numpy(pix))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
    dj = jcam.add_distortion(ji.disto_kind, ji.disto, pj)
    dt = tcam.add_distortion(ti.disto_kind, ti.disto, pt)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
    # pixels on the 0..80 scale: float32 rounding of p * f + pp
    np.testing.assert_allclose(
        tcam.cam2ima(ti, dt).numpy(), np.asarray(jcam.cam2ima(ji, dj)), atol=1e-4
    )
    assert tcam.DISTO_NAMES == jcam.DISTO_NAMES and tcam.CAM_NAMES == jcam.CAM_NAMES


def test_sgm_depth_list_identical():
    _, _, K, R, c = render_views(n_views=4, wh=(80, 60), focal_px=70.0, arc=0.4)
    rng = np.random.RandomState(3)
    pts = rng.randn(60, 3) * 0.8
    obs_lm = np.concatenate([np.arange(60)] * 4)
    obs_view = np.repeat(np.arange(4), 60)
    obs_uv = rng.rand(240, 2) * [160, 120]
    K_all = {v: K.astype(np.float32) for v in range(4)}
    hw = {v: (80, 60) for v in range(4)}
    args = (pts, obs_lm, obs_view, obs_uv, 0, dict(enumerate(R)), dict(enumerate(c)),
            K_all, hw, [1, 2, 3], 48)
    for roi in (None, (0, 0, 80, 60)):
        a = jdl.sgm_depth_list(*args, roi=roi)
        b = tdl.sgm_depth_list(*args, roi=roi)
        np.testing.assert_array_equal(b.depths, a.depths)
        np.testing.assert_array_equal(b.tc_limits, a.tc_limits)
        assert (b.d_min, b.d_max, b.n_obs) == (a.d_min, a.d_max, a.n_obs)
    assert tdl.view_depth_range(pts, obs_lm, obs_view, obs_uv, 9, R[0], c[0]) is None
