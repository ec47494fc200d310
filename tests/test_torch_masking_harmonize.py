"""The port's masking and colour harmonization against the JAX package's,
on the CPU.

Masks are bit-equal: HSV boxes (a wrapping hue range, inversion), the
threshold mask, Otsu's threshold (the port counts its histogram in
integers and takes the variances in float64, so it picks JAX's bin on
these images) and 3x3 dilation, erosion and closing.

The IRLS gains and offsets: its normal matrix N has cond ~4e4-6e4 here, so
any float32 evaluation lies within ~eps32 cond(N) of the float64 solution
(the JAX package's within 1.5e-4-8.7e-4 of it); on the CPU, where both run
in float32, the port's gains and offsets are held to JAX's within
2 eps32 cond(N) and each to the float64 IRLS within eps32 cond(N). The
card's route (float64 throughout) is held on the CPU by patching the
precision choice, to the float64 IRLS within its float32 result's rounding
(1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu.misc import color_harmonization as jch
from alicevision_tpu.misc import masking as jmk
from alicevision_tpu_torch.misc import color_harmonization as tch
from alicevision_tpu_torch.misc import masking as tmk

torch.set_num_threads(1)


def _image(seed=0, hw=(48, 64)):
    """RGB in [0, 1] with flat patches (s = 0, v = 0 or 1, exact ties of
    the max channel) among random pixels."""
    rng = np.random.RandomState(seed)
    img = rng.rand(*hw, 3).astype(np.float32)
    img[:8, :8] = 0.5
    img[8:12, :8] = 0.0
    img[12:16, :8] = [1.0, 1.0, 0.2]
    img[16:20, :8] = [0.3, 0.9, 0.9]
    return img


HSV_CASES = {
    "all": {},
    "green": dict(h_range=(0.25, 0.45), s_range=(0.5, 1.0)),
    "red_wrapping": dict(h_range=(0.95, 0.05), s_range=(0.3, 1.0)),
    "dark_inverted": dict(v_range=(0.0, 0.4), invert=True),
}


def test_rgb_to_hsv_matches():
    img = _image()
    np.testing.assert_array_equal(tmk.rgb_to_hsv(torch.from_numpy(img)).numpy(), np.asarray(jmk.rgb_to_hsv(img)))


@pytest.mark.parametrize("case", list(HSV_CASES))
def test_hsv_mask_bit_equal(case):
    img = _image(1)
    got = tmk.hsv_mask(torch.from_numpy(img), **HSV_CASES[case]).numpy()
    want = np.asarray(jmk.hsv_mask(jnp.asarray(img), **HSV_CASES[case]))
    assert got.dtype == np.bool_ and np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_otsu_and_threshold_masks_bit_equal(seed):
    rng = np.random.RandomState(seed)
    # a bimodal image: two Gaussian populations, clipped to [0, 1]
    gray = np.where(rng.rand(64, 80) < 0.4, rng.normal(0.3, 0.08, (64, 80)),
                    rng.normal(0.7, 0.1, (64, 80))).astype(np.float32)
    gray[0, :4] = [-0.5, 1.5, 0.0, 1.0]
    t = torch.from_numpy(gray)
    assert float(tmk.otsu_threshold(t)) == float(jmk.otsu_threshold(jnp.asarray(gray)))
    assert np.array_equal(tmk.auto_threshold_mask(t).numpy(), np.asarray(jmk.auto_threshold_mask(jnp.asarray(gray))))
    assert np.array_equal(tmk.threshold_mask(t, 0.2, 0.6).numpy(),
                          np.asarray(jmk.threshold_mask(jnp.asarray(gray), 0.2, 0.6)))


@pytest.mark.parametrize("op", ["dilate", "erode", "closing"])
@pytest.mark.parametrize("iterations", [0, 1, 3])
def test_morphology_bit_equal(op, iterations):
    rng = np.random.RandomState(iterations)
    mask = rng.rand(33, 47) < 0.3
    mask[0, :] = True  # the border: -inf / +inf outside, as "SAME" pads
    got = getattr(tmk, op)(torch.from_numpy(mask), iterations).numpy()
    want = np.asarray(getattr(jmk, op)(jnp.asarray(mask), iterations))
    assert np.array_equal(got, want)


def _constraints(seed=0, n_views=4):
    """Matched-quantile constraints between views of one texture under
    known gains and offsets (tests/test_color_harmonize_cli.py's setup)."""
    rng = np.random.default_rng(seed)
    from scipy.signal import convolve2d

    base = convolve2d(rng.random((90, 120)) * 0.5 + 0.25, np.ones((5, 5)) / 25.0, mode="same")
    g = rng.uniform(0.7, 1.3, n_views)
    o = rng.uniform(-0.05, 0.05, n_views)
    imgs = [np.clip(base * gi + oi, 0, 1) for gi, oi in zip(g, o)]
    xy = np.stack([rng.uniform(8, 112, 150), rng.uniform(8, 82, 150)], axis=1)
    edges, mi, mj = [], [], []
    for i in range(n_views):
        for j in range(i + 1, n_views):
            got = tch.matched_quantile_constraints(imgs[i], imgs[j], xy, xy)
            want = jch.matched_quantile_constraints(imgs[i], imgs[j], xy, xy)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
            for a, b in zip(*got):
                edges.append((i, j))
                mi.append(float(a))
                mj.append(float(b))
    return np.asarray(edges), np.asarray(mi, np.float32), np.asarray(mj, np.float32), g, o


def _irls64(n_views, edges, mi, mj, irls_iters=3):
    """The IRLS of `harmonize_gains` in float64 numpy: (gains, offsets,
    cond of the last normal matrix)."""
    E, (ii, jj) = len(edges), edges.T
    mi, mj = mi.astype(np.float64), mj.astype(np.float64)
    big = float(np.float32(10.0) * np.sqrt(np.float32(E)))

    def solve(w):
        A, rows = np.zeros((E + 2, 2 * n_views)), np.arange(E)
        np.add.at(A, (rows, ii), w * mi)
        np.add.at(A, (rows, n_views + ii), w)
        np.add.at(A, (rows, jj), -w * mj)
        np.add.at(A, (rows, n_views + jj), -w)
        b = np.zeros(E + 2)
        A[E, 0], b[E], A[E + 1, n_views] = big, big, big
        N = A.T @ A + 1e-9 * np.eye(2 * n_views)
        x = np.linalg.solve(N, A.T @ b)
        return x[:n_views], x[n_views:], np.linalg.cond(N)

    g, o, c = solve(np.ones(E))
    for _ in range(irls_iters):
        g, o, c = solve(1.0 / (np.abs((g[ii] * mi + o[ii]) - (g[jj] * mj + o[jj])) + 1e-2))
    return g, o, c


@pytest.mark.parametrize("seed", [0, 1])
def test_harmonize_gains_match(seed):
    edges, mi, mj, g_true, _ = _constraints(seed)
    g, o = tch.harmonize_gains(len(g_true), edges, mi, mj, device="cpu")
    jg, jo = jch.harmonize_gains(len(g_true), edges, jnp.asarray(mi), jnp.asarray(mj))
    g64, o64, cond = _irls64(len(g_true), edges, mi, mj)
    tol = np.finfo(np.float32).eps * cond
    assert g.dtype == torch.float32 and g.device.type == "cpu"
    for got, want, ref in ((g.numpy(), np.asarray(jg), g64), (o.numpy(), np.asarray(jo), o64)):
        np.testing.assert_allclose(got, want, atol=2 * tol, rtol=0)
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
        np.testing.assert_allclose(want, ref, atol=tol, rtol=0)
    rel = g.numpy() * g_true / (g.numpy()[0] * g_true[0])
    np.testing.assert_allclose(rel, 1.0, atol=0.02)


def test_harmonize_gains_float64_route(monkeypatch):
    """The card's route on the CPU, by patching the precision choice: the
    float64 IRLS with `numeric.solve64`, against float64 numpy."""
    edges, mi, mj, g_true, _ = _constraints(2)
    calls = []

    def solve64(A, b):
        calls.append(A.dtype)
        return tch.solve64(A, b)

    monkeypatch.setattr(tch, "_precision", lambda dev: (torch.float64, solve64))
    g, o = tch.harmonize_gains(len(g_true), edges, mi, mj, device="cpu")
    g64, o64, _ = _irls64(len(g_true), edges, mi, mj)
    assert calls == [torch.float64] * 4 and g.dtype == torch.float32  # the first solve and 3 IRLS steps
    np.testing.assert_allclose(g.numpy(), g64, atol=1e-6, rtol=0)  # float32 rounding of the result
    np.testing.assert_allclose(o.numpy(), o64, atol=1e-6, rtol=0)
    rel = g.numpy() * g_true / (g.numpy()[0] * g_true[0])
    np.testing.assert_allclose(rel, 1.0, atol=0.02)


def test_patch_means_match():
    rng = np.random.RandomState(3)
    img = rng.rand(40, 50)
    xy = np.concatenate([rng.uniform(-3, 53, (60, 2)), [[0.0, 0.0], [49.4, 39.6]]])
    np.testing.assert_array_equal(tch.patch_means(img, xy, 3), jch.patch_means(img, xy, 3))


def test_harmonize_needs_cuda_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    edges, mi, mj, g_true, _ = _constraints(0, n_views=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tch.harmonize_gains(2, edges, mi, mj)
