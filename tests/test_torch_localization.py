"""The port's localization (`localization/`: the landmark index,
`match_2d3d`, `localize_image`, `VoctreeLocalizer`, `rig_resection`, the
marker localizer and `refine_sequence`) against the JAX reference on the
CPU.

The scene is the JAX package's ring scene (8 views, 240 points) with a
random unit descriptor a landmark, seen with noise in each view
(tests/test_voctree_localizer.py's construction, smaller). The libraries'
random streams differ, so the port is handed the reference's draws: its
vocabulary tree (`convert.voctree_from_numpy`) and its RANSAC sample
indices, drawn by `sample_minimal` with the key the JAX function passes
down (split per rig camera as `rig_resection` splits it). With the same
draws the two select the same hypotheses: inlier counts are equal and the
poses agree within 1e-3 (R) and 1e-3 units (centres); the Gauss-Newton
polishes (closed-form Jacobians or `torch.func.jacfwd` in the port,
`jax.jvp`/`jax.linearize`/`jax.jacfwd` in the reference) are held on
their results. Retrieval compares the top views as sets (`topk` ties).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu import camera as jcam
from alicevision_tpu import robust as jrb
from alicevision_tpu.features import markers as jmk
from alicevision_tpu.geometry.rotations import so3_exp as j_so3_exp
from alicevision_tpu.localization import localizer as jloc
from alicevision_tpu.localization import marker_localizer as jml
from alicevision_tpu.localization import voctree_localizer as jvl
from alicevision_tpu.utils.synthetic import ring_scene
from alicevision_tpu_torch import convert
from alicevision_tpu_torch import robust as trb
from alicevision_tpu_torch.features import markers as tmk
from alicevision_tpu_torch.localization import localizer as tloc
from alicevision_tpu_torch.localization import marker_localizer as tml
from alicevision_tpu_torch.localization import voctree_localizer as tvl

torch.set_num_threads(1)

j_sample = jax.jit(jrb.sample_minimal, static_argnums=(1, 2, 3))
RTOL_R, TOL_C = 1e-3, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _jitted_reference_resection():
    """The reference's robust P3P, jitted once for the module (it runs
    eagerly inside the localizers, compiling every primitive)."""
    jitted = jax.jit(jrb.robust_resection_p3p, static_argnames=("im_size", "n_hyps", "max_error_px", "refine_iters"))
    orig = jrb.robust_resection_p3p

    def call(key, world, obs, focal, im_size, valid=None, n_hyps=128, max_error_px=4.0, refine_iters=8):
        return jitted(key, world, obs, focal, tuple(float(x) for x in im_size), valid, n_hyps=n_hyps,
                      max_error_px=float(max_error_px), refine_iters=refine_iters)

    jrb.robust_resection_p3p = call
    yield
    jrb.robust_resection_p3p = orig


def _idx(key, n, n_hyps, floor=32):
    """The sample indices `robust_resection_p3p(key, ...)` draws for n
    correspondences padded to the localizers' power-of-two capacity."""
    cap = max(floor, 1 << int(np.ceil(np.log2(max(n, floor)))))
    return np.asarray(j_sample(key, cap, 3, n_hyps, jnp.asarray(np.arange(cap) < n)))


@pytest.fixture(scope="module")
def scene():
    """Ring scene + descriptors: (points, landmark descriptors, obs
    landmark, obs view, obs descriptors, obs pixels, poses R, c, focal,
    (w, h), the JAX intrinsics)."""
    n_views, n_points, D = 8, 240, 32
    sc = ring_scene(n_views=n_views, n_points=n_points, seed=0)
    rng = np.random.default_rng(0)
    lm_desc = rng.normal(size=(n_points, D))
    lm_desc /= np.linalg.norm(lm_desc, axis=1, keepdims=True)
    vis = np.asarray(sc.visible)
    obs_np = np.asarray(sc.observations)
    o_lm, o_view, o_desc, o_uv = [], [], [], []
    for v in range(n_views):
        ids = np.nonzero(vis[v])[0]
        d = lm_desc[ids] + rng.normal(0, 0.05, (len(ids), D))
        o_lm.extend(ids)
        o_view.extend([v] * len(ids))
        o_desc.append(d / np.linalg.norm(d, axis=1, keepdims=True))
        o_uv.append(obs_np[v, ids])
    intr = sc.intrinsics
    return dict(points=np.asarray(sc.points), lm_desc=lm_desc, o_lm=np.asarray(o_lm), o_view=np.asarray(o_view),
                o_desc=np.concatenate(o_desc).astype(np.float32), o_uv=np.concatenate(o_uv),
                R=np.asarray(sc.poses.R), c=np.asarray(sc.poses.c), f=float(np.asarray(intr.scale)[0]),
                wh=tuple(float(x) for x in np.asarray(intr.size)), intr=intr)


def _query(scene, view, seed=1):
    """A query of `view`'s observations: noisy descriptors, normalized
    coordinates, and 20 random outlier features."""
    rows = np.nonzero(scene["o_view"] == view)[0]
    rng = np.random.default_rng(seed)
    q_desc = scene["o_desc"][rows] + rng.normal(0, 0.02, scene["o_desc"][rows].shape)
    p = jcam.ima2cam(scene["intr"], jnp.asarray(scene["o_uv"][rows]))
    q_norm = np.asarray(jcam.remove_distortion(scene["intr"].disto_kind, scene["intr"].disto, p))
    out_d = rng.normal(size=(20, q_desc.shape[1]))
    out_n = rng.uniform(-0.5, 0.5, (20, 2))
    return (np.concatenate([q_desc, out_d]).astype(np.float32), np.concatenate([q_norm, out_n]).astype(np.float32))


def _assert_pose(port, ref):
    assert port.success == ref.success and port.n_inliers == ref.n_inliers
    np.testing.assert_allclose(port.R, np.asarray(ref.R), atol=RTOL_R)
    np.testing.assert_allclose(port.c, np.asarray(ref.c), atol=TOL_C)


def test_landmark_index_and_match_2d3d(scene):
    held = scene["o_view"] != 5
    args = (scene["points"], scene["o_lm"][held], scene["o_desc"][held])
    d_j, p_j = jloc.build_landmark_index(*args)
    d_t, p_t = tloc.build_landmark_index(*args)
    np.testing.assert_array_equal(d_t, d_j)
    np.testing.assert_array_equal(p_t, p_j)
    q_desc, q_norm = _query(scene, 5)
    w_j, o_j = jloc.match_2d3d(d_j, p_j, q_desc, q_norm)
    w_t, o_t = tloc.match_2d3d(d_t, p_t, q_desc, q_norm, device="cpu")
    assert len(w_t) > 30
    np.testing.assert_array_equal(w_t, w_j)
    np.testing.assert_array_equal(o_t, o_j)


def test_localize_image(scene):
    held = scene["o_view"] != 5
    lm = jloc.build_landmark_index(scene["points"], scene["o_lm"][held], scene["o_desc"][held])
    q_desc, q_norm = _query(scene, 5)
    key = jax.random.PRNGKey(3)
    ref = jloc.localize_image(key, *lm, q_desc, q_norm, scene["f"], scene["wh"])
    n = len(jloc.match_2d3d(*lm, q_desc, q_norm)[0])
    port = tloc.localize_image(None, *lm, q_desc, q_norm, scene["f"], scene["wh"], idx=_idx(key, n, 256),
                               device="cpu")
    assert ref.success
    _assert_pose(port, ref)
    assert np.linalg.norm(port.c - scene["c"][5]) < 0.01 * 5.0


def test_resection_without_meaningful_hypothesis_is_rejected():
    """12 correspondences with no geometry (random points and
    observations): no hypothesis has a fourth residual under the 4-px cap,
    so AC-RANSAC's NFA is +inf. The reference's estimator then keeps the
    threshold at acransac_select's padding value on some draws and counts
    every point in front of the camera as an inlier: a localizer would
    accept the pose. The port's estimator gives the same counts on the same
    draws; its localizers (`resect_padded`) take such a resection for no
    inliers."""
    rng = np.random.RandomState(0)
    n, cap, f, wh = 12, 32, 900.0, (1280.0, 960.0)
    world = rng.uniform(-1.0, 1.0, (n, 3)) + np.array([0.0, 0.0, 6.0])
    obs = rng.uniform(-0.6, 0.6, (n, 2))
    W = np.pad(world, ((0, cap - n), (0, 0))).astype(np.float32)
    O = np.pad(obs, ((0, cap - n), (0, 0))).astype(np.float32)
    V = np.array(np.arange(cap) < n)
    accepted = 0
    for k in range(8):
        key = jax.random.PRNGKey(k)
        ref = jrb.robust_resection_p3p(key, jnp.asarray(W), jnp.asarray(O), f, wh, valid=jnp.asarray(V), n_hyps=256)
        idx = _idx(key, n, 256)
        est = trb.robust_resection_p3p(None, torch.from_numpy(W), torch.from_numpy(O), f, wh, valid=torch.from_numpy(V),
                                       n_hyps=256, idx=torch.tensor(idx, dtype=torch.int64))
        assert not np.isfinite(float(ref.nfa)) and not torch.isfinite(est.nfa)
        assert tloc.resect_padded(None, world, obs, f, wh, 256, idx=idx, device="cpu")[2] == 0
        if float(ref.threshold_sq) > 1e17:  # the padding value: every point in front counts
            assert float(est.threshold_sq) > 1e17 and int(est.n_inliers) == int(ref.n_inliers)
            accepted += int(ref.n_inliers) >= 12
    assert accepted > 0


def test_voctree_localizer(scene):
    held = scene["o_view"] != 5
    db = (scene["points"], scene["o_lm"][held], scene["o_view"][held], scene["o_desc"][held])
    ref = jvl.VoctreeLocalizer(*db)
    port = tvl.VoctreeLocalizer(*db, tree=convert.voctree_from_numpy(ref.tree, device="cpu"), device="cpu")
    np.testing.assert_allclose(port.db.tfidf.numpy(), np.asarray(ref.db.tfidf), atol=1e-6)
    q_desc, q_norm = _query(scene, 5)
    assert set(port.retrieve(q_desc).tolist()) == set(ref.retrieve(q_desc).tolist())
    key = jax.random.PRNGKey(4)
    r_ref = ref.localize(key, q_desc, q_norm, scene["f"], scene["wh"])
    world, _, _ = port.correspondences(q_desc, q_norm, port.retrieve(q_desc))
    seconds = {}
    r_port = port.localize(None, q_desc, q_norm, scene["f"], scene["wh"], idx=_idx(key, len(world), 256),
                           seconds=seconds)
    assert r_ref.success
    _assert_pose(r_port, r_ref)
    assert set(seconds) == {"retrieval", "matching", "resection"}


def _rig_problem(seed=0, n=80):
    rng = np.random.default_rng(seed)
    R_f = np.asarray(j_so3_exp(jnp.asarray([0.1, -0.2, 0.15], jnp.float32)))
    c_f = np.array([0.3, -0.4, -4.0])
    sub_R = np.stack([np.eye(3), np.asarray(j_so3_exp(jnp.asarray([0.01, 0.02, -0.01], jnp.float32)))])
    sub_t = np.stack([np.zeros(3), np.array([0.3, 0.0, 0.02])])
    pts = rng.uniform(-1.5, 1.5, (n, 3))
    world_pc, obs_pc = [], []
    for s in range(2):
        xc = ((pts - c_f) @ R_f.T) @ sub_R[s].T + sub_t[s]
        obs = xc[:, :2] / xc[:, 2:3] + rng.normal(0, 0.5 / 800.0, (n, 2))
        out = rng.choice(n, n // 5, replace=False)
        obs[out] += rng.uniform(-0.2, 0.2, (len(out), 2))
        world_pc.append(pts)
        obs_pc.append(obs)
    return R_f, c_f, sub_R, sub_t, world_pc, obs_pc


def test_rig_resection(scene):
    R_f, c_f, sub_R, sub_t, world_pc, obs_pc = _rig_problem()
    key = jax.random.PRNGKey(0)
    ref = jvl.rig_resection(key, world_pc, obs_pc, sub_R, sub_t, 800.0, (1280.0, 960.0))
    idx, k = [], key
    for w in world_pc:
        k, sub = jax.random.split(k)
        idx.append(_idx(sub, len(w), 128))
    port = tvl.rig_resection(None, world_pc, obs_pc, sub_R, sub_t, 800.0, (1280.0, 960.0), idx_per_cam=idx,
                             device="cpu")
    assert ref.success and port.success and port.n_inliers == ref.n_inliers
    np.testing.assert_allclose(port.R_frame, ref.R_frame, atol=RTOL_R)
    np.testing.assert_allclose(port.c_frame, ref.c_frame, atol=TOL_C)
    assert np.linalg.norm(port.c_frame - c_f) < 5e-3


def _look_at(c):
    fwd = -c / np.linalg.norm(c)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd])


def _project(R, c, X, f, pp):
    Xc = (X - c) @ R.T
    return f * Xc[:, :2] / Xc[:, 2:3] + np.asarray(pp)


def test_localize_by_markers():
    rng = np.random.RandomState(1)
    f, W, H = 500.0, 640.0, 480.0
    marker_world = {i: rng.uniform(-1, 1, 3) for i in range(12)}
    c_gt = np.array([0.0, -5.0, 0.0])
    R_gt = _look_at(c_gt)
    dets = [jmk.MarkerDetection(m, _project(R_gt, c_gt, X[None], f, (W / 2, H / 2))[0], None, 20.0)
            for m, X in marker_world.items()]
    dets[0] = jmk.MarkerDetection(0, np.array([10.0, 10.0]), None, 20.0)  # a gross mis-detection
    key = jax.random.PRNGKey(0)
    ref = jml.localize_by_markers(key, dets, marker_world, f, (W, H))
    port = tml.localize_by_markers(None, [tmk.MarkerDetection(*d) for d in dets], marker_world, f, (W, H),
                                   idx=_idx(key, len(dets), 64, floor=8), device="cpu")
    assert ref.success
    _assert_pose(port, ref)
    assert np.linalg.norm(port.c - c_gt) < 0.05


def test_localize_image_by_markers():
    """CCTags pasted into an image, their centres back-projected at known
    depths from an identity camera: both packages detect and localize."""
    f, W, H = 400.0, 480, 360
    img = np.ones((H, W), np.float32)
    spots = [(70, 70, 0), (70, 240, 3), (70, 400, 6), (250, 90, 9), (250, 260, 12), (240, 400, 15)]
    for y, x, m in spots:
        patch = jmk.render_cctag(m, size=97)
        img[y - 48:y + 49, x - 48:x + 49] = patch
    depths = {m: 4.0 + 0.3 * k for k, (_, _, m) in enumerate(spots)}
    world = {m: depths[m] * np.array([(x - W / 2) / f, (y - H / 2) / f, 1.0]) for y, x, m in spots}
    key = jax.random.PRNGKey(2)
    ref = jml.localize_image_by_markers(key, img, world, f)
    n = len(jmk.detect_cctags(img))
    port = tml.localize_image_by_markers(None, img, world, f, idx=_idx(key, n, 64, floor=8), device="cpu")
    assert ref.success and n == len(spots)
    _assert_pose(port, ref)
    np.testing.assert_allclose(port.R, np.eye(3), atol=0.02)


@pytest.mark.parametrize("refine_focal", [True, False])
def test_refine_sequence(refine_focal):
    rng = np.random.RandomState(2)
    F, M = 6, 48
    f_gt, W, H = 420.0, 640.0, 480.0
    pp = (W / 2, H / 2)
    pts = rng.uniform(-1, 1, (M, 3)) * np.array([2.0, 2.0, 0.8])
    Rs, cs, uvs = [], [], []
    for k in range(F):
        a = 2 * np.pi * k / 40.0
        c = np.array([4.0 * np.sin(a), -4.0 * np.cos(a), 0.5])
        R = _look_at(c)
        Rs.append(R)
        cs.append(c)
        uvs.append(_project(R, c, pts, f_gt, pp) + rng.normal(0, 0.2, (M, 2)))
    Rs, cs, uvs = np.stack(Rs), np.stack(cs), np.stack(uvs)
    dR = np.asarray(jax.vmap(j_so3_exp)(jnp.asarray(0.02 * rng.randn(F, 3), jnp.float32)))
    R0 = np.einsum("fij,fjk->fik", dR, Rs)
    t0 = -np.einsum("fij,fj->fi", Rs, cs) + 0.05 * rng.randn(F, 3)
    world = np.broadcast_to(pts, (F, M, 3))
    mask = np.ones((F, M), bool)
    mask[0, :5] = False
    kw = dict(focal0=f_gt * 1.08, principal=pp, n_rounds=3, refine_focal=refine_focal)
    ref = jml.refine_sequence(R0, t0, world, uvs, mask, **kw)
    port = tml.refine_sequence(R0, t0, world, uvs, mask, device="cpu", **kw)
    np.testing.assert_allclose(port.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(port.t.numpy(), np.asarray(ref.t), atol=1e-3)
    np.testing.assert_allclose(float(port.focal), float(ref.focal), rtol=1e-4)
    np.testing.assert_allclose(float(port.rms_px), float(ref.rms_px), rtol=1e-3)
    if refine_focal:
        assert abs(float(port.focal) - f_gt) / f_gt < 0.01
