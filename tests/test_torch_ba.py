"""The port's bundle adjuster against the JAX reference, on the CPU.

Problems are built by the JAX package (the scenes of tests/test_ba.py and
tests/test_rig_ba.py) and carried into the port with
`convert.ba_problem_from_numpy`, so both solve the same float32 inputs.
Tolerances are stated at each check; they cover float32 rounding of sums
taken in another order (XLA vs torch), amplified by the conditioning of the
reduced camera system where a solve is involved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu import camera as jcam
from alicevision_tpu import geometry as jgeo
from alicevision_tpu.sfm import ba as jba
from alicevision_tpu.utils.synthetic import ring_scene
from alicevision_tpu_torch import numeric
from alicevision_tpu_torch.convert import ba_problem_from_numpy
from alicevision_tpu_torch.sfm import ba as tba

torch.set_num_threads(1)

RADIUS = 5.0  # ring radius of the scenes; positions are held within 1e-4 of it


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    """max |a - b| / max |b|."""
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _flat_obs(scene, n_views):
    vis = np.asarray(scene.visible)
    obs = np.asarray(scene.observations)
    o_cam, o_lm = np.nonzero(vis)
    return o_lm, o_cam, obs[o_cam, o_lm]


def _make_problem(noise_px=0.0, n_views=8, n_points=120, seed=1, max_track=None):
    """tests/test_ba.py::_make_problem: a ring scene with perturbed poses
    (cameras 0-1 held) and points."""
    scene = ring_scene(n_views=n_views, n_points=n_points, noise_px=noise_px, seed=0)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    fixed = jnp.arange(n_views) < 2
    dw = jnp.where(fixed[:, None], 0.0, 0.02 * jax.random.normal(k1, (n_views, 3)))
    dc = jnp.where(fixed[:, None], 0.0, 0.02 * jax.random.normal(k2, (n_views, 3)))
    q0 = jgeo.mat_to_quat(jgeo.so3_exp(dw) @ scene.poses.R)
    c0 = scene.poses.c + dc
    X0 = scene.points + 0.05 * jax.random.normal(k3, scene.points.shape)
    o_lm, o_cam, o_uv = _flat_obs(scene, n_views)
    intr = jax.tree_util.tree_map(lambda a: a[None], scene.intrinsics)
    return jba.build_problem(
        q0, c0, X0, intr, o_lm, o_cam, np.zeros(len(o_lm), np.int32), o_uv,
        max_track=max_track or n_views, cam_fixed=np.asarray(fixed),
    )


def _disto_problem(all_fixed=True, focal_scale=1.0):
    """tests/test_ba.py::test_ba_with_distortion's scene (RADIALK3)."""
    scene = ring_scene(
        n_views=6, n_points=80, disto_kind=jcam.DISTO_RADIALK3,
        disto_params=(-0.15, 0.02, -0.001), seed=0,
    )
    k1, _ = jax.random.split(jax.random.PRNGKey(3))
    X0 = scene.points + 0.03 * jax.random.normal(k1, scene.points.shape)
    o_lm, o_cam, o_uv = _flat_obs(scene, 6)
    intr = scene.intrinsics._replace(scale=scene.intrinsics.scale * focal_scale)
    intr = jax.tree_util.tree_map(lambda a: a[None], intr)
    return jba.build_problem(
        scene.poses.q, scene.poses.c, X0, intr, o_lm, o_cam, np.zeros(len(o_lm), np.int32),
        o_uv, max_track=6, cam_fixed=np.ones(6, bool) if all_fixed else np.arange(6) < 2,
    )


def _rig_problem(n_frames=6, n_points=120, seed=0):
    """tests/test_rig_ba.py::_make_rig_problem at a smaller size: a two-camera
    rig on a ring, frames, points and sub-pose 1 perturbed."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    centers = np.stack([RADIUS * np.cos(ang), RADIUS * np.sin(ang), np.zeros(n_frames)], -1)
    fwd = -centers / np.linalg.norm(centers, axis=-1, keepdims=True)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    R_f = np.stack([right, np.cross(fwd, right), fwd], axis=-2)
    R_s1 = np.asarray(jgeo.so3_exp(jnp.asarray([[0.02, -0.015, 0.01]])))[0]
    sub_R = np.stack([np.eye(3), R_s1])
    sub_t = np.stack([np.zeros(3), np.array([0.4, 0.02, -0.01])])
    pts = rng.uniform(-1.5, 1.5, (n_points, 3))
    f, w_img, h_img = 800.0, 1280.0, 960.0
    intr = jax.tree_util.tree_map(lambda a: np.asarray(a)[None], jcam.make_intrinsics(w_img, h_img, f))
    o_lm, o_cam, o_sub, o_uv = [], [], [], []
    for fr in range(n_frames):
        for s in range(2):
            xc = ((pts - centers[fr]) @ R_f[fr].T) @ sub_R[s].T + sub_t[s]
            uv = f * xc[:, :2] / xc[:, 2:3] + np.array([w_img / 2, h_img / 2])
            ok = (xc[:, 2] > 0.5) & (np.abs(uv[:, 0] - w_img / 2) < w_img / 2) \
                & (np.abs(uv[:, 1] - h_img / 2) < h_img / 2)
            idx = np.nonzero(ok)[0]
            o_lm.extend(idx)
            o_cam.extend([fr] * len(idx))
            o_sub.extend([s] * len(idx))
            o_uv.extend(uv[idx])
    q_gt = np.asarray(jgeo.mat_to_quat(jnp.asarray(R_f, jnp.float32)))
    q0 = q_gt + rng.normal(0, 0.005, q_gt.shape)
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    q0[:2] = q_gt[:2]
    c0 = centers + rng.normal(0, 0.005, centers.shape)
    c0[:2] = centers[:2]
    dR = np.asarray(jgeo.so3_exp(jnp.asarray(rng.normal(0, 0.02, (1, 3)))))[0]
    sq0 = np.asarray(jgeo.mat_to_quat(jnp.asarray(np.stack([np.eye(3), dR @ R_s1]), jnp.float32)))
    st0 = np.stack([sub_t[0], sub_t[1] + rng.normal(0, 0.02, 3)])
    return jba.build_problem(
        q0, c0, pts + rng.normal(0, 0.02, pts.shape), intr,
        np.array(o_lm), np.array(o_cam), np.zeros(len(o_lm), np.int32), np.array(o_uv),
        max_track=12, cam_fixed=np.arange(n_frames) < 2,
        obs_sub=np.array(o_sub), sub_q=sq0, sub_t=st0,
    )


def _port(problem):
    return ba_problem_from_numpy(jax.tree_util.tree_map(np.asarray, problem), device="cpu")


@pytest.fixture(scope="module")
def noisy():
    jp = _make_problem(noise_px=0.5)
    return jp, _port(jp)


@pytest.fixture(scope="module")
def rig():
    jp = _rig_problem()
    return jp, _port(jp)


def _assert_same_geometry(tres, jres):
    # centres and points within 1e-4 of the scene radius: both optimizers
    # reach the same float32 optimum, which rounding moves by ~1e-6;
    # rotations as matrices (a quaternion's sign is free)
    np.testing.assert_allclose(_np(tres.cam_c), _np(jres.cam_c), atol=1e-4 * RADIUS)
    np.testing.assert_allclose(_np(tres.points), _np(jres.points), atol=1e-4 * RADIUS)
    Rt = np.asarray(jgeo.quat_to_mat(jnp.asarray(_np(tres.cam_q))))
    np.testing.assert_allclose(Rt, np.asarray(jgeo.quat_to_mat(jres.cam_q)), atol=1e-4)


# ---------------------------------------------------------------- problem


def test_build_problem_tables_equal():
    """Same flat observations -> identical (L, K) tables, including rows
    longer than max_track (truncated) and rig sub-pose indices."""
    rng = np.random.RandomState(0)
    L, C, n_obs = 40, 9, 260
    obs_lm = rng.randint(0, L, n_obs)
    obs_cam = rng.randint(0, C, n_obs)
    obs_intr = rng.randint(0, 2, n_obs).astype(np.int32)
    obs_uv = rng.rand(n_obs, 2).astype(np.float32) * 1000
    obs_sub = rng.randint(0, 3, n_obs)
    q = rng.randn(C, 4).astype(np.float32)
    c = rng.randn(C, 3).astype(np.float32)
    X = rng.randn(L, 3).astype(np.float32)
    rows = [jcam.make_intrinsics(640, 480, 500.0), jcam.make_intrinsics(800, 600, 700.0)]
    jintr = jcam.stack_intrinsics(rows)
    nintr = jax.tree_util.tree_map(np.asarray, jintr)
    sq, st = rng.randn(3, 4).astype(np.float32), rng.randn(3, 3).astype(np.float32)
    fixed = np.arange(C) < 2
    jp = jba.build_problem(q, c, X, jintr, obs_lm, obs_cam, obs_intr, obs_uv, max_track=5,
                           cam_fixed=fixed, obs_sub=obs_sub, sub_q=sq, sub_t=st)
    tp = tba.build_problem(q, c, X, nintr, obs_lm, obs_cam, obs_intr, obs_uv, max_track=5,
                           cam_fixed=fixed, obs_sub=obs_sub, sub_q=sq, sub_t=st, device="cpu")
    for name in tba.BAProblem._fields:
        if name == "intr":
            for a, b in zip(tp.intr, jp.intr):
                np.testing.assert_array_equal(_np(a), np.asarray(b))
            continue
        t, j = _np(getattr(tp, name)), np.asarray(getattr(jp, name))
        assert t.dtype == j.dtype, name
        np.testing.assert_array_equal(t, j, err_msg=name)
    carried = _port(jp)
    for name in ("obs_cam", "obs_uv", "obs_mask", "obs_sub", "cam_fixed"):
        assert torch.equal(getattr(carried, name), getattr(tp, name)), name


def test_build_problem_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    intr = jax.tree_util.tree_map(lambda a: np.asarray(a)[None], jcam.make_intrinsics(64, 48, 50.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        tba.build_problem(np.eye(1, 4), np.zeros((1, 3)), np.zeros((1, 3)), intr,
                          [0], [0], [0], np.zeros((1, 2)), max_track=1)


# ------------------------------------------------------- residuals, steps


@pytest.mark.parametrize("which", ["pinhole", "radialk3", "rig"])
def test_residuals_and_jacobians_match(which, noisy, rig):
    jp, tp = {"pinhole": noisy, "rig": rig}.get(which) or (lambda p: (p, _port(p)))(_disto_problem())
    r, Jc, Jl = jba._residuals_and_jacobians(jp, jp.cam_q, jp.cam_c, jp.points)
    tr, tJc, tJl = tba._residuals_and_jacobians(tp, tp.cam_q, tp.cam_c, tp.points)
    # residuals of a few px, Jacobian entries up to ~1e3: float32 rounding
    # of the same closed forms, rtol 1e-4 of each array's magnitude
    for a, b in ((tr, r), (tJc, Jc), (tJl, Jl)):
        assert a.shape == b.shape
        assert _rel(a, b) < 1e-4
    np.testing.assert_allclose(
        _np(tba._residuals(tp, tp.cam_q, tp.cam_c, tp.points)), np.asarray(r), atol=1e-4 * np.abs(r).max()
    )


def test_joint_jacobians_match():
    jp = _disto_problem(all_fixed=False, focal_scale=1.01)
    tp = _port(jp)
    idx = (0, 1, 2, 3, 4, 5, 6)
    dt = np.zeros((1, 4 + jcam.DISTO_PARAMS), np.float32)
    dt[0, 0] = 2.0
    dt[0, 4] = 0.01
    out_j = jba._residuals_and_jacobians(jp, jp.cam_q, jp.cam_c, jp.points,
                                         dtheta=jnp.asarray(dt), intr_param_idx=idx)
    out_t = tba._residuals_and_jacobians(tp, tp.cam_q, tp.cam_c, tp.points,
                                         dtheta=torch.from_numpy(dt), intr_param_idx=idx)
    for a, b in zip(out_t, out_j):  # r, Jc, Jl, Jt
        assert a.shape == b.shape
        assert _rel(a, b) < 1e-4


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_schur_step_matches(solver, noisy):
    jp, tp = noisy
    r, Jc, Jl = jba._residuals_and_jacobians(jp, jp.cam_q, jp.cam_c, jp.points)
    tr, tJc, tJl = tba._residuals_and_jacobians(tp, tp.cam_q, tp.cam_c, tp.points)
    jfn = jba._schur_solve if solver == "dense" else jba._schur_solve_pcg
    tfn = tba._schur_solve if solver == "dense" else tba._schur_solve_pcg
    dxc, dxp = jfn(jp, r, Jc, Jl, jnp.float32(1e-4))
    tdxc, tdxp = tfn(tp, tr, tJc, tJl, torch.tensor(1e-4))
    # one damped step: the reduced system's conditioning amplifies float32
    # rounding of its assembly, rtol 1e-3 of the step's magnitude
    assert _rel(tdxc, dxc) < 1e-3
    assert _rel(tdxp, dxp) < 1e-3


def test_closed_form_3x3_blocks_match():
    """_sym3_inv and _chol3 on SPD blocks V = A A^T + 0.1 I: the same
    closed forms, float32 rounding apart (rtol 1e-5 of each block)."""
    rng = np.random.RandomState(7)
    A = rng.randn(64, 3, 3).astype(np.float32)
    V = A @ np.swapaxes(A, 1, 2) + 0.1 * np.eye(3, dtype=np.float32)
    for jf, tf in ((jba._sym3_inv, tba._sym3_inv), (jba._chol3, tba._chol3)):
        ref = np.asarray(jf(jnp.asarray(V)))
        out = tf(torch.from_numpy(V)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


# ------------------------------------------------------------------ solves


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_ba_solve_matches(solver, noisy):
    jp, tp = noisy
    # rtol 1e-3: both stop at iteration 3, whose step lowers the cost by
    # 1e-5..7e-4 relative, after iteration 2's 0.32. Closer to the optimum
    # the decrease of a step is at the level of float32 cost noise, and the
    # stopping iteration would follow the rounding, not the algorithm.
    jres = jba.ba_solve(jp, max_iters=25, solver=solver, rtol=1e-3)
    tres = tba.ba_solve(tp, max_iters=25, solver=solver, rtol=1e-3)
    np.testing.assert_allclose(float(tres.cost_final), float(jres.cost_final), rtol=1e-3)
    np.testing.assert_allclose(float(tres.cost_initial), float(jres.cost_initial), rtol=1e-5)
    assert abs(int(tres.n_iters) - int(jres.n_iters)) <= 1
    _assert_same_geometry(tres, jres)
    # the held cameras do not move
    np.testing.assert_array_equal(_np(tres.cam_c[:2]), _np(tp.cam_c[:2]))


def test_ba_solve_unrolled_matches(noisy):
    """loop="unrolled": exactly max_iters LM iterations, the PCG a fixed
    count with convergence masking (the bench configurations)."""
    jp, tp = noisy
    jres = jba.ba_solve(jp, max_iters=6, rtol=0.0, solver="pcg", cg_iters=8, loop="unrolled")
    before = tba.host_syncs
    tres = tba.ba_solve(tp, max_iters=6, rtol=0.0, solver="pcg", cg_iters=8, loop="unrolled")
    assert tba.host_syncs == before  # nothing read back
    assert int(tres.n_iters) == int(jres.n_iters) == 6
    np.testing.assert_allclose(float(tres.cost_final), float(jres.cost_final), rtol=1e-3)
    _assert_same_geometry(tres, jres)


def test_ba_solve_while_counts_host_reads(noisy):
    _, tp = noisy
    before = tba.host_syncs
    res = tba.ba_solve(tp, max_iters=4, solver="dense", rtol=0.0)
    assert tba.host_syncs - before == int(res.n_iters) == 4  # one read per LM iteration


def test_refine_intrinsics_matches():
    """tests/test_intrinsics_refine_kvld.py's setting: focal 3% off, no
    distortion guess, poses and points held."""
    scene = ring_scene(n_views=8, n_points=150, disto_kind=jcam.DISTO_RADIALK3,
                       disto_params=(-0.12, 0.02, 0.0), seed=0)
    o_lm, o_cam, o_uv = _flat_obs(scene, 8)
    wrong = scene.intrinsics._replace(scale=scene.intrinsics.scale * 1.03,
                                      disto=jnp.zeros(jcam.DISTO_PARAMS))
    intr = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a))[None], wrong)
    jp = jba.build_problem(scene.poses.q, scene.poses.c, scene.points, intr, o_lm, o_cam,
                           np.zeros(len(o_lm), np.int32), o_uv, max_track=8)
    tp = _port(jp)
    jref = jba.refine_intrinsics(jp, jp.cam_q, jp.cam_c, jp.points, iters=6)
    tref = tba.refine_intrinsics(tp, tp.cam_q, tp.cam_c, tp.points, iters=6)
    np.testing.assert_allclose(_np(tref.scale), np.asarray(jref.scale), rtol=1e-4)
    np.testing.assert_allclose(_np(tref.offset), np.asarray(jref.offset), atol=1e-2)
    np.testing.assert_allclose(_np(tref.disto), np.asarray(jref.disto), atol=1e-3)
    np.testing.assert_allclose(_np(tref.scale[0]), np.asarray(scene.intrinsics.scale), rtol=2e-3)


@pytest.mark.parametrize(
    "C,L", [(8, 120), (192, 1000), (193, 1000), (100, 10_000), (150, 100_000), (192, 233_000)]
)
def test_auto_solver_choice(C, L):
    """The same problem size picks the same solver in both packages: the
    JAX rule of ba_solve (C <= 192 and B = 6C x 3L float32 <= 1.5 GB)."""
    assert tba._DENSE_SCHUR_MAX_CAMS == jba._DENSE_SCHUR_MAX_CAMS
    expect = "dense" if C <= jba._DENSE_SCHUR_MAX_CAMS and 6 * C * 3 * L * 4 <= (3 << 29) else "pcg"
    assert tba._auto_solver(C, L) == expect


def test_auto_solver_routes_many_cams_to_pcg(noisy):
    """tests/test_ba.py::test_ba_auto_solver_picks_pcg_for_many_cams: a
    problem padded to 256 cameras solves through PCG under "auto"."""
    _, tp = noisy
    pad = 256 - tp.cam_q.shape[0]
    big = tp._replace(
        cam_q=torch.cat([tp.cam_q, torch.tensor([[1.0, 0, 0, 0]]).repeat(pad, 1)]),
        cam_c=torch.cat([tp.cam_c, torch.zeros(pad, 3)]),
        cam_fixed=torch.cat([tp.cam_fixed, torch.ones(pad, dtype=torch.bool)]),
    )
    auto = tba.ba_solve(big, max_iters=4, solver="auto")
    pcg = tba.ba_solve(big, max_iters=4, solver="pcg")
    assert float(auto.cost_final) == float(pcg.cost_final)
    assert float(auto.cost_final) < float(auto.cost_initial) * 1e-2


def test_rms_reprojection_error_matches(noisy, rig):
    for jp, tp in (noisy, rig):
        ref = float(jba.rms_reprojection_error(jp, jp.cam_q, jp.cam_c, jp.points))
        out = float(tba.rms_reprojection_error(tp, tp.cam_q, tp.cam_c, tp.points))
        np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_f32_matmuls_restores_settings():
    prev = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("high")
    try:
        seen = {}

        @numeric.f32_matmuls
        def probe():
            seen["p"] = torch.get_float32_matmul_precision()
            seen["tf32"] = torch.backends.cuda.matmul.allow_tf32
            raise KeyError("inside")

        with pytest.raises(KeyError):
            probe()
        assert seen == {"p": "highest", "tf32": False}
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]


def test_chip_smoke_ba_problems_on_cpu():
    """chip_smoke.py's BA builders at small sizes: the headline scene
    converges below its 0.05 px check, the banded large scene lowers its
    cost through PCG, and the mid-size scene takes the dense solver."""
    import chip_smoke

    head = chip_smoke.make_headline_problem("cpu", n_views=12, n_points=300)
    res = tba.ba_solve(head, max_iters=10, rtol=0.0, solver="dense", loop="unrolled")
    assert float(tba.rms_reprojection_error(head, res.cam_q, res.cam_c, res.points)) < chip_smoke.BA_HEADLINE_RMS_PX
    large = chip_smoke.make_large_problem("cpu", C=48, L=2000)
    assert large.obs_mask.shape == (2000, 6)
    res = tba.ba_solve(large, max_iters=3, rtol=0.0, solver="pcg", cg_iters=8, loop="unrolled")
    assert float(res.cost_final) < float(res.cost_initial)
    mid = chip_smoke.make_mid_problem("cpu", n_points=400)
    assert tba._auto_solver(mid.cam_q.shape[0], mid.points.shape[0]) == "dense"
    moved = chip_smoke.problem_to(mid, "cpu")
    assert torch.equal(moved.obs_uv, mid.obs_uv) and torch.equal(moved.intr.scale, mid.intr.scale)
