"""The port's rig tools (`misc/rig.py`, `sfm/rig_sequence.py`,
`sfm/expansion.py::ExpansionPostProcessRig`) against the JAX reference on
the CPU, on tests/test_rig_ba.py's two-camera rig scenes (smaller).

Quaternion averages and calibrated sub-poses are held within 1e-5. The rig
sequence runs the alternating rig BA (`ba.rig_solve`) in both packages;
LM's stopping iteration near the optimum follows float32 noise, so the
solves are compared on their results: sub-poses within 2e-3 rad and 2e-3
units, view centres within 2e-3 of the ring's radius (5 units), and both
against the truth (tests/test_rig_ba.py's gates); they run in
tests/test_torch_rig_sequence.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_rig_ba import _make_rig_problem

from alicevision_tpu import geometry as jgeo
from alicevision_tpu.misc import rig as jrig
from alicevision_tpu.sfm import rig_sequence as jrs
from alicevision_tpu_torch.misc import rig as trig
from alicevision_tpu_torch.sfm import rig_sequence as trs

torch.set_num_threads(1)

N_FRAMES, N_POINTS = 6, 90


def _rotations(rng, n, scale):
    return np.asarray(jgeo.so3_exp(jnp.asarray(rng.normal(0, scale, (n, 3)), jnp.float32)))


def test_average_quaternions():
    rng = np.random.default_rng(0)
    q = np.array(jgeo.mat_to_quat(jnp.asarray(_rotations(rng, 9, 0.05) @ _rotations(rng, 1, 1.0)[0])))
    q[::3] *= -1  # the average is sign-invariant
    w = rng.uniform(0.5, 2.0, 9).astype(np.float32)
    for weights in (None, w):
        ref = np.asarray(jrig.average_quaternions(jnp.asarray(q), None if weights is None else jnp.asarray(weights)))
        got = trig.average_quaternions(torch.from_numpy(q), None if weights is None else torch.from_numpy(weights))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_calibrate_rig():
    rng = np.random.default_rng(1)
    R_rel = _rotations(rng, 1, 0.2)[0]
    c_rel = np.array([0.3, 0.0, -0.1])
    R0 = _rotations(rng, 12, 1.0).astype(np.float64)
    c0 = rng.normal(size=(12, 3))
    R1 = np.einsum("ij,fjk->fik", R_rel, R0)
    c1 = c0 + np.einsum("fji,j->fi", R0, c_rel)
    cams = [(R0, c0), (R1, c1)]
    ref = jrig.calibrate_rig(cams)
    got = trig.calibrate_rig(cams, device="cpu")
    for (Rg, cg), (Rr, cr) in zip(got, ref):
        np.testing.assert_allclose(Rg, Rr, atol=1e-5)
        np.testing.assert_allclose(cg, cr, atol=1e-5)
    np.testing.assert_allclose(got[1][0], R_rel, atol=1e-4)
    np.testing.assert_allclose(got[1][1], c_rel, atol=1e-4)


@pytest.fixture(scope="module")
def rig_views():
    """tests/test_rig_ba.py::test_rig_sequence_from_independent_views's
    inputs at a smaller size: noisy independently-posed rig views, flat
    observations keyed by view, and the truth."""
    problem, gt = _make_rig_problem(n_frames=N_FRAMES, n_points=N_POINTS, seed=5)
    rng = np.random.default_rng(7)
    sub_R, sub_t, R_f = gt["sub_R"], gt["sub_t"], gt["R_f"]
    view_frame = np.repeat(np.arange(N_FRAMES), 2)
    view_sub = np.tile(np.arange(2), N_FRAMES)
    R_v = np.einsum("vij,vjk->vik", sub_R[view_sub], R_f[view_frame])
    c_v = gt["centers"][view_frame] - np.einsum("vji,vkj,vk->vi", R_f[view_frame], sub_R[view_sub],
                                                 sub_t[view_sub])
    R_noisy = np.einsum("vij,vjk->vik", _rotations(rng, 2 * N_FRAMES, 0.01), R_v)
    c_noisy = c_v + rng.normal(0, 0.02, c_v.shape)
    L, K = problem.obs_mask.shape
    m = np.asarray(problem.obs_mask)
    o_lm = np.broadcast_to(np.arange(L)[:, None], (L, K))[m]
    o_view = (np.asarray(problem.obs_cam) * 2 + np.asarray(problem.obs_sub))[m]
    o_uv = np.asarray(problem.obs_uv)[m]
    pts0 = np.asarray(problem.points) + rng.normal(0, 0.02, (L, 3))
    intr = tuple(np.asarray(a) for a in problem.intr)
    return dict(R=R_noisy, c=c_noisy, view_frame=view_frame, view_sub=view_sub, pts=pts0, intr=intr, o_lm=o_lm,
                o_view=o_view, o_uv=o_uv, gt=gt, c_v=c_v, R_v=R_v, intr_jax=problem.intr)


def test_estimate_subposes(rig_views):
    d = rig_views
    posed = np.ones(2 * N_FRAMES, bool)
    posed[2] = False  # frame 1 completed from its sub-1 view
    args = (d["R"], d["c"], posed, d["view_frame"], d["view_sub"], 2)
    ref = jrs.estimate_subposes(*args)
    got = trs.estimate_subposes(*args, device="cpu")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-5)
    assert got[4].all()
    ang = np.degrees(np.arccos(np.clip((np.trace(got[0][1] @ d["gt"]["sub_R"][1].T) - 1) / 2, -1, 1)))
    assert ang < 1.0


def _angle_deg(A, B):
    return np.degrees(np.arccos(np.clip((np.trace(A @ B.T) - 1) / 2, -1, 1)))
