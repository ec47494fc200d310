"""The hard scene in the port (`utils/rendered.py`'s ring of 40 occluded
views with radial K3 distortion, noise and outlier matches) against the JAX
package on the CPU, and the port's SfM engine held to
tests/test_hard_scene.py's gates on it.

- `hard_scene`, `verified_matches_from_scene`: host numpy in both, equal
  arrays and equal match sets.
- `undistort_radial_k3`: the numpy copy and the float64 tensor path within
  1e-9 of the reference.
- `render_hard_views` (float64 torch on the CPU) against its numpy copy and
  the JAX package's at 2 views of 160x120: within 1e-6 on all but at most
  0.1 % of the pixels (a texel boundary or a silhouette that float64 sums in
  another order put on the other side); the CPU run has 0 such pixels.
- The engine: 40 views, the reference's normal prior (focal 2 % off, zero
  K3) and its stressed prior (10 % focal, a (20, -12) px principal point),
  with `robust_triangulation=True` (tests/test_torch_hard_scene_engine.py
  runs the engine on `_run_engine`). On the CPU it runs with 64 RANSAC
  hypotheses and 3 initial-pair candidates in place of 256 and 10 (10-11 s
  a run on one thread, against 20-30 s at the defaults), which meets the
  same gates; `chip_smoke.py` holds the defaults to them on the card. The
  gates: normal prior >= 38 of 40 posed, ATE < 1 % of the radius, k1 within
  0.03, focal within 1 %, centres within 0.02 of
  tests/golden/hard_scene_poses.npz after alignment; stressed prior >= 36
  posed, ATE < 1.5 %, focal within 2 %, k1 within 0.06, the principal point
  within 0.65 of the prior's offset.
- `numeric.eigh` / `svd`: NaN for a non-finite matrix, as JAX's, where
  torch's raise for the whole batch (the stressed prior's first joint
  refine leaves k1 near -1.3, the undistortion of a few corner observations
  diverges, and the engine stopped on the triangulation's eigh).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu.multiview import triangulation as jtri
from alicevision_tpu.utils import rendered as jr
from alicevision_tpu_torch import camera as cam
from alicevision_tpu_torch import numeric
from alicevision_tpu_torch.multiview import triangulation as ttri
from alicevision_tpu_torch.sfm.incremental import IncrementalConfig, IncrementalSfM
from alicevision_tpu_torch.tracks.builder import build_tracks
from alicevision_tpu_torch.utils import rendered as tr

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "hard_scene_poses.npz")
CPU_CONFIG = dict(n_ransac_hyps=64, init_pair_candidates=3)
RENDER_ATOL, RENDER_MAX_FLIPPED = 1e-6, 1e-3


def _align_similarity(a, b):
    mu_a, mu_b = a.mean(0), b.mean(0)
    ac, bc = a - mu_a, b - mu_b
    U, S, Vt = np.linalg.svd(bc.T @ ac / len(a))
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / ((ac**2).sum() / len(a))
    return s, R, mu_b - s * R @ mu_a


def test_hard_scene_equals_reference():
    a, b = tr.hard_scene(40, 600), jr.hard_scene(40, 600)
    for name in tr.HardScene._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)), err_msg=name)
    pm, fxy, nf = tr.verified_matches_from_scene(a)
    pm_j, fxy_j, nf_j = jr.verified_matches_from_scene(b)
    assert pm.keys() == pm_j.keys() and nf == nf_j
    for k in pm:
        np.testing.assert_array_equal(pm[k], pm_j[k])
    for v in fxy:
        np.testing.assert_array_equal(fxy[v], fxy_j[v])
    assert len(pm) >= 150  # the closed ring of 4 neighbours a view


def test_undistort_radial_k3():
    rng = np.random.RandomState(0)
    xd = rng.uniform(-0.8, 0.8, (500, 2))
    disto = (-0.25, 0.06, -0.005)
    ref = jr.undistort_radial_k3(xd, disto)
    np.testing.assert_allclose(tr.undistort_radial_k3(xd, disto), ref, atol=1e-9, rtol=0)
    out = tr._undistort_radial_k3_torch(torch.from_numpy(xd), disto)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-9, rtol=0)


def test_render_hard_views_matches():
    kw = dict(n_views=2, wh=(160, 120), focal_px=900.0 * 160 / 1280)
    imgs, K, disto, R, c = tr.render_hard_views(device="cpu", **kw)
    plain = tr.render_hard_views_numpy(**kw)
    ref = jr.render_hard_views(**kw)
    assert imgs.shape == (2, 120, 160) and imgs.dtype == np.float32
    for other in (plain, ref):
        for a, b in zip((K, disto, R, c), other[1:]):
            np.testing.assert_array_equal(a, b)
        diff = np.abs(imgs - other[0])
        flipped = (diff > RENDER_ATOL).mean()
        assert flipped <= RENDER_MAX_FLIPPED, flipped
    np.testing.assert_array_equal(plain[0], ref[0])
    assert 0.1 < imgs.std() and (imgs == 0.5).mean() < 0.9  # texture, not background
    some = tr.render_hard_views_numpy(views=[1], **kw)[0]
    np.testing.assert_array_equal(some[0], plain[0][1])


def test_render_hard_views_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.render_hard_views(n_views=1, wh=(16, 12))


def test_eigh_and_svd_give_nan_for_non_finite_matrices():
    rng = np.random.RandomState(1)
    A = rng.randn(5, 4, 4)
    G = A @ A.transpose(0, 2, 1)
    G[2, 1, 3] = G[2, 3, 1] = np.nan
    G[4, 0, 0] = np.inf
    w, V = numeric.eigh(torch.from_numpy(G).float())
    w_j, _ = jnp.linalg.eigh(jnp.asarray(G, jnp.float32))
    bad = np.array([False, False, True, False, True])
    assert np.isnan(w.numpy()[bad]).all() and np.isnan(V.numpy()[bad]).all()
    assert np.isnan(np.asarray(w_j)[bad]).all()  # as the reference's
    np.testing.assert_allclose(w.numpy()[~bad], np.asarray(w_j)[~bad], rtol=1e-5, atol=1e-5)
    U, s, Vt = numeric.svd(torch.from_numpy(A[:, :3, :]).float().masked_fill(torch.from_numpy(bad)[:, None, None], torch.nan))
    assert np.isnan(s.numpy()[bad]).all() and np.isfinite(s.numpy()[~bad]).all()
    assert U.shape == (5, 3, 3) and Vt.shape == (5, 4, 4)


def test_robust_triangulation_drops_a_nan_observation_as_reference():
    """One track's observation is NaN (a diverged undistortion): the
    reference gives that track a NaN point and triangulates the others;
    the port does the same."""
    rng = np.random.RandomState(2)
    n_tracks, K = 6, 4
    R = np.stack([np.eye(3)] * K)
    c = np.stack([[-1.0, 0, -5], [1.0, 0, -5], [0, 1.0, -5], [0, -1.0, -5]])
    P = np.concatenate([R, -np.einsum("kij,kj->ki", R, c)[..., None]], -1)
    X = rng.uniform(-0.5, 0.5, (n_tracks, 3))
    x = (np.einsum("kij,tj->tki", P[:, :, :3], X) + P[None, :, :, 3])
    x = x[..., :2] / x[..., 2:]
    x[3, 1] = np.nan
    Pb = np.broadcast_to(P, (n_tracks, K, 3, 4)).astype(np.float32)
    mask = np.ones((n_tracks, K), bool)
    X_j, inl_j, ok_j = jtri.triangulate_nview_robust(jnp.asarray(Pb), jnp.asarray(x, jnp.float32),
                                                     mask=jnp.asarray(mask), threshold_px=1e-3)
    X_t, inl_t, ok_t = ttri.triangulate_nview_robust(torch.from_numpy(Pb), torch.from_numpy(x).float(),
                                                     mask=torch.from_numpy(mask), threshold_px=1e-3)
    good = np.arange(n_tracks) != 3
    np.testing.assert_allclose(X_t.numpy()[good], X[good], atol=1e-4)
    np.testing.assert_allclose(X_t.numpy()[good], np.asarray(X_j)[good], atol=1e-5)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))


def _run_engine(stressed: bool):
    hs = tr.hard_scene(40, 600)
    pm, fxy, nf = tr.verified_matches_from_scene(hs)
    tracks = build_tracks(pm, nf, min_track_length=2)
    w, h = hs.image_size
    intr = cam.make_intrinsics(
        w, h, float(hs.K[0, 0]) * (1.10 if stressed else 1.02),
        disto_kind=cam.DISTO_RADIALK3, disto_params=(0.0, 0.0, 0.0),
        offset=(20.0, -12.0) if stressed else (0.0, 0.0),
    )
    intr = cam.Intrinsics(*(x[None] for x in intr))
    cfg = IncrementalConfig(robust_triangulation=True, seed=0, **CPU_CONFIG)
    engine = IncrementalSfM(tracks, fxy, intr, np.zeros(40, np.int32), np.tile([w, h], (40, 1)), cfg,
                            device="cpu")
    res = engine.process()
    posed = np.nonzero(res.posed)[0]
    s, R, t = _align_similarity(res.pose_c[posed], hs.c[posed])
    ate = np.sqrt(np.mean(np.sum((res.pose_c[posed] @ (s * R).T + t - hs.c[posed]) ** 2, axis=1)))
    radius = np.linalg.norm(hs.c - hs.c.mean(0), axis=1).mean()
    return hs, engine, res, posed, ate / radius
