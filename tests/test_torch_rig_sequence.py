"""The port's rig sequence solve and its rig expansion post-process against
the JAX package's on the CPU, on tests/test_torch_rig.py's rig views (its
fixture and tolerances). The two share one JAX compile (the same max_track
and gauge).

A file of its own, apart from the rig's host helpers, so that the two
solves start early on their own test worker.
"""

import jax
import numpy as np
import torch

from alicevision_tpu.sfm import expansion as jexp
from alicevision_tpu.sfm import rig_sequence as jrs
from alicevision_tpu_torch import camera as tcam
from alicevision_tpu_torch.sfm import expansion as texp
from alicevision_tpu_torch.sfm import rig_sequence as trs
from test_torch_rig import N_FRAMES, _angle_deg, rig_views  # noqa: F401 (rig_views: a fixture)

torch.set_num_threads(1)


def test_solve_rig_sequence(rig_views):
    d = rig_views
    posed = np.ones(2 * N_FRAMES, bool)
    args = (d["R"], d["c"], posed, d["view_frame"], d["view_sub"], 2, d["pts"])
    obs = (d["o_lm"], d["o_view"], np.zeros(len(d["o_lm"]), np.int32), d["o_uv"])
    kw = dict(rounds=2)  # the post-process's max_track and gauge: one JAX compile for both tests
    ref = jrs.solve_rig_sequence(*args, jax.tree_util.tree_map(np.asarray, d["intr_jax"]), *obs, **kw)
    got = trs.solve_rig_sequence(*args, tcam.Intrinsics(*d["intr"]), *obs, device="cpu", **kw)
    assert _angle_deg(got[2][1], ref[2][1]) < 2e-3 * 180 / np.pi
    np.testing.assert_allclose(got[3], ref[3], atol=2e-3)
    np.testing.assert_allclose(got[1], ref[1], atol=2e-3 * 5.0)
    for R_g, R_r in zip(got[0], ref[0]):
        assert _angle_deg(R_g, R_r) < 0.05
    assert _angle_deg(got[2][1], d["gt"]["sub_R"][1]) < 0.2
    assert np.linalg.norm(got[3][1] - d["gt"]["sub_t"][1]) < 0.01


class _Res:
    pass


def _engine(d, device_attr):
    """The slice of an IncrementalSfM that ExpansionPostProcessRig reads and
    writes: every rig view posed, every landmark valid, the observations
    flat (track, view, uv) with all inliers."""
    e = _Res()
    e.res = _Res()
    e.res.pose_R, e.res.pose_c = d["R"].copy(), d["c"].copy()
    e.res.posed = np.ones(2 * N_FRAMES, bool)
    e.res.points = d["pts"].copy()
    e.res.point_valid = np.ones(len(d["pts"]), bool)
    e.res.history = []
    e.obs_track, e.obs_view, e.obs_uv = d["o_lm"], d["o_view"], d["o_uv"].astype(np.float32)
    e.obs_inlier = np.ones(len(d["o_lm"]), bool)
    e.view_intrinsic = np.zeros(2 * N_FRAMES, np.int32)
    if device_attr:
        e.intr_np, e.device = tcam.Intrinsics(*d["intr"]), torch.device("cpu")
    else:
        e.intr_np = jax.tree_util.tree_map(np.asarray, d["intr_jax"])
    return e


def test_expansion_post_process_rig(rig_views):
    d = rig_views
    ej, et = _engine(d, False), _engine(d, True)
    sub_R_j, sub_t_j = jexp.ExpansionPostProcessRig(d["view_frame"], d["view_sub"], 2, rounds=2).process(ej)
    sub_R_t, sub_t_t = texp.ExpansionPostProcessRig(d["view_frame"], d["view_sub"], 2, rounds=2).process(et)
    assert et.res.history == ej.res.history == [("rig_postprocess", 2)]
    assert _angle_deg(sub_R_t[1], sub_R_j[1]) < 2e-3 * 180 / np.pi
    np.testing.assert_allclose(sub_t_t, sub_t_j, atol=2e-3)
    np.testing.assert_allclose(et.res.pose_c, ej.res.pose_c, atol=2e-3 * 5.0)
    np.testing.assert_allclose(et.res.points, ej.res.points, atol=1e-2)
    assert _angle_deg(sub_R_t[1], d["gt"]["sub_R"][1]) < 0.2
