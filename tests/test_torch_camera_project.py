"""The port's projection, undistortion and back-projection against the JAX
reference, on the CPU, for each camera kind x distortion kind; and the
synthetic ring scene built on them.

Tolerances: 1e-4 px on pixels (float32 rounding of the same closed forms at
a 1000 px focal) and 1e-6 on unit rays and normalized coordinates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu import camera as jcam
from alicevision_tpu.utils import synthetic as jsyn
from alicevision_tpu_torch import camera as tcam
from alicevision_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

DISTOS = [
    (jcam.DISTO_NONE, ()),
    (jcam.DISTO_RADIALK1, (-0.2,)),
    (jcam.DISTO_RADIALK3, (-0.25, 0.08, -0.01)),
    (jcam.DISTO_BROWN, (-0.2, 0.05, -0.005, 0.001, -0.0015)),
    (jcam.DISTO_FISHEYE, (0.1, -0.02, 0.003, -0.0004)),
    (jcam.DISTO_FISHEYE1, (0.9,)),
]
KINDS = [jcam.CAM_PINHOLE, jcam.CAM_EQUIDISTANT]


def _intr(kind, disto, params):
    args = (1920, 1080, 1000.0)
    kw = dict(cam_kind=kind, disto_kind=disto, disto_params=params, offset=(3.0, -2.0))
    return jcam.make_intrinsics(*args, **kw), tcam.make_intrinsics(*args, **kw)


def _points(seed, n=256):
    rng = np.random.RandomState(seed)
    z = rng.uniform(1.0, 10.0, (n, 1))
    xy = rng.uniform(-0.4, 0.4, (n, 2)) * z
    return np.concatenate([xy, z], -1).astype(np.float32)


def test_make_intrinsics_matches():
    j, t = _intr(jcam.CAM_EQUIDISTANT, jcam.DISTO_BROWN, DISTOS[3][1])
    for a, b in zip(t, j):
        assert a.dtype == {np.int32: torch.int32, np.float32: torch.float32}[np.asarray(b).dtype.type]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    js = jcam.stack_intrinsics([j, j])
    ts = tcam.stack_intrinsics([t, t])
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tcam.K_matrix(ts).numpy(), np.asarray(jcam.K_matrix(js)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("disto,params", DISTOS)
def test_project_cam_matches(kind, disto, params):
    j, t = _intr(kind, disto, params)
    x = _points(disto * 7 + kind)
    ref = np.asarray(jcam.project_cam(j, jnp.asarray(x)))
    out = tcam.project_cam(t, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    ref_nd = np.asarray(jcam.project_cam(j, jnp.asarray(x), apply_distortion=False))
    out_nd = tcam.project_cam(t, torch.from_numpy(x), apply_distortion=False).numpy()
    np.testing.assert_allclose(out_nd, ref_nd, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("disto,params", DISTOS)
def test_project_cam_jacobian_matches(kind, disto, params):
    """The port's closed-form d pix / d x_cam against JAX's forward-mode
    derivative of project_cam: within 1e-5 of the largest entry (float32
    rounding of different but exact expressions)."""
    j, t = _intr(kind, disto, params)
    x = _points(40 + disto * 2 + kind)
    ref = np.asarray(jax.vmap(jax.jacfwd(lambda v: jcam.project_cam(j, v)))(jnp.asarray(x)))
    pix, J = tcam.project_cam_jacobian(t, torch.from_numpy(x))
    assert J.shape == ref.shape == (len(x), 2, 3)
    np.testing.assert_allclose(J.numpy(), ref, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(pix.numpy(), tcam.project_cam(t, torch.from_numpy(x)).numpy(), atol=0)


@pytest.mark.parametrize("disto,params", DISTOS)
def test_remove_distortion_matches(disto, params):
    j, t = _intr(jcam.CAM_PINHOLE, disto, params)
    p = np.random.RandomState(disto).uniform(-0.45, 0.45, (512, 2)).astype(np.float32)
    d = np.asarray(jcam.add_distortion(j.disto_kind, j.disto, jnp.asarray(p)))
    ref = np.asarray(jcam.remove_distortion(j.disto_kind, j.disto, jnp.asarray(d)))
    out = tcam.remove_distortion(t.disto_kind, t.disto, torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("disto,params", DISTOS)
def test_backproject_ray_matches(kind, disto, params):
    j, t = _intr(kind, disto, params)
    pix = np.random.RandomState(11 + disto).uniform([300, 150], [1620, 930], (256, 2)).astype(np.float32)
    for remove in (True, False):
        ref = np.asarray(jcam.backproject_ray(j, jnp.asarray(pix), remove_disto=remove))
        out = tcam.backproject_ray(t, torch.from_numpy(pix), remove_disto=remove).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6)


def test_batched_mixed_models():
    """One table of four intrinsic rows, gathered per point."""
    rows = [_intr(k, d, p) for k, (d, p) in zip([0, 1, 0, 1], DISTOS[1:5])]
    js = jcam.stack_intrinsics([r[0] for r in rows])
    ts = tcam.stack_intrinsics([r[1] for r in rows])
    x = _points(3, 64)
    idx = np.arange(64) % 4
    ref = np.asarray(jcam.project_cam(jax.tree_util.tree_map(lambda a: a[idx], js), jnp.asarray(x)))
    out = tcam.project_cam(tcam.Intrinsics(*(a[torch.from_numpy(idx)] for a in ts)), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("disto,params,noise", [(0, (), 0.0), (2, (-0.15, 0.02, -0.001), 0.5)])
def test_ring_scene_matches(disto, params, noise):
    """The ring scene with the reference's drawn points and noise passed in:
    poses, projections and visibility agree (the draws themselves come from
    another generator)."""
    kw = dict(n_views=6, n_points=80, disto_kind=disto, disto_params=params, seed=0)
    js = jsyn.ring_scene(noise_px=noise, **kw)
    jclean = jsyn.ring_scene(**kw)
    unit_noise = (np.asarray(js.observations) - np.asarray(jclean.observations)) / noise if noise else None
    ts = tsyn.ring_scene(noise_px=noise, points=np.asarray(js.points), noise=unit_noise, device="cpu", **kw)
    Rj = np.asarray(js.poses.R)
    np.testing.assert_allclose(ts.poses.R.numpy(), Rj, atol=1e-6)
    np.testing.assert_allclose(ts.poses.c.numpy(), np.asarray(js.poses.c), atol=1e-5)
    np.testing.assert_allclose(ts.observations.numpy(), np.asarray(js.observations), atol=1e-3)
    vis_j, vis_t = np.asarray(js.visible), ts.visible.numpy()
    assert (vis_j != vis_t).sum() <= 1  # a projection on an image border may round either way
    np.testing.assert_allclose(
        tsyn.normalized_obs(ts).numpy(), np.asarray(jsyn.normalized_obs(js)), atol=1e-6
    )


def test_ring_scene_draws_from_its_seed():
    a = tsyn.ring_scene(n_views=5, n_points=50, noise_px=0.3, seed=3, device="cpu")
    b = tsyn.ring_scene(n_views=5, n_points=50, noise_px=0.3, seed=3, device="cpu")
    assert torch.equal(a.observations, b.observations)
    assert float(torch.linalg.norm(a.points, dim=-1).max()) <= 1.5 + 1e-6
    assert a.visible.sum() > 100
