"""The port's colour spaces, image processing, split360 and lens/camera
profiles (`image/colorspace.py`, `image/processing.py`, `utils/lcp.py`,
`utils/dcp.py`) against the JAX package's, on the CPU.

Tolerances: elementwise colour conversions 1e-5 relative (Lab's L and a/b
span ~100, its cube root is `x ** (1/3)` where JAX takes `cbrt`); filters,
resizes, warps and crops to float32 rounding (1e-5); the host parsers
(LCP alternates, DCP matrices) equal. The LCP and DCP fixtures are
tests/test_localba_lcp_feeds.py's and tests/test_image_cache_dcp.py's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu.image import colorspace as jcs
from alicevision_tpu.image import processing as jproc
from alicevision_tpu.utils import dcp as jdcp
from alicevision_tpu.utils import lcp as jlcp
from alicevision_tpu_torch.image import colorspace as tcs
from alicevision_tpu_torch.image import processing as tproc
from alicevision_tpu_torch.utils import dcp as tdcp
from alicevision_tpu_torch.utils import lcp as tlcp
from test_image_cache_dcp import _DCP_XML
from test_localba_lcp_feeds import _LCP_SAMPLE

torch.set_num_threads(1)

ATOL = 1e-5
SPACES = ["linear", "srgb", "rec709", "aces2065-1", "acescg", "xyz", "lab"]


def _img(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("space", SPACES)
def test_convert_matches(space):
    x = _img((64, 3))
    for src, dst in (("linear", space), (space, "linear")):
        xin = x * 100.0 - np.array([0, 50, 50], np.float32) if src == "lab" else x
        ref = np.asarray(jcs.convert(jnp.asarray(xin), src, dst))
        got = tcs.convert(torch.from_numpy(xin), src, dst).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=ATOL * max(1.0, np.abs(ref).max()))


def test_convert_dispatch_and_errors():
    x = torch.full((4, 3), 0.5)
    assert tcs.convert(x, "auto", "srgb") is x and tcs.convert(x, "srgb", "srgb") is x
    for bad in (("arri_logc3", "linear"), ("nope", "linear"), ("linear", "nope")):
        with pytest.raises(ValueError):
            tcs.convert(x, *bad)
    lab = tcs.linear_rgb_to_lab(torch.ones(1, 3)).numpy()
    np.testing.assert_allclose(lab, np.asarray(jcs.linear_rgb_to_lab(jnp.ones((1, 3)))), atol=1e-4)


@pytest.mark.parametrize("shape,scale", [((64, 48), 0.5), ((30, 40, 3), 1.7), ((33, 21), 0.3)])
def test_resize_matches(shape, scale):
    img = _img(shape)
    ref = np.asarray(jproc.resize(jnp.asarray(img), scale))
    got = tproc.resize(torch.from_numpy(img), scale).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_filters_match():
    img = _img((40, 52))
    cases = [
        (lambda m, x: m.sharpen(x, 1.0)),
        (lambda m, x: m.adjust_contrast(x, 2.0)),
        (lambda m, x: m.bilateral_denoise(x, sigma_range=0.5)),
    ]
    for f in cases:
        np.testing.assert_allclose(f(tproc, torch.from_numpy(img)).numpy(), np.asarray(f(jproc, jnp.asarray(img))),
                                   atol=ATOL)
    rgb = _img((20, 24, 3))
    np.testing.assert_allclose(tproc.bilateral_denoise(torch.from_numpy(rgb), radius=2).numpy(),
                               np.asarray(jproc.bilateral_denoise(jnp.asarray(rgb), radius=2)), atol=ATOL)
    mask = np.ones((40, 52), bool)
    mask[10:25, 12:30] = False
    ref = np.asarray(jproc.fill_holes(jnp.asarray(img), jnp.asarray(mask), iterations=20))
    got = tproc.fill_holes(torch.from_numpy(img), torch.from_numpy(mask), iterations=20).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("channels,pitch", [(0, 0.0), (3, 15.0)])
def test_split_equirect_matches(channels, pitch):
    pano = _img((64, 128) + ((channels,) if channels else ()), seed=1)
    ij, Kj, Rj = jproc.split_equirect(jnp.asarray(pano), n_splits=4, fov_deg=80.0, out_size=48, pitch_deg=pitch)
    it, Kt, Rt = tproc.split_equirect(torch.from_numpy(pano), n_splits=4, fov_deg=80.0, out_size=48, pitch_deg=pitch)
    np.testing.assert_allclose(Rt, Rj, atol=1e-6)
    np.testing.assert_allclose(Kt.numpy(), np.asarray(Kj), rtol=1e-6)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), atol=ATOL)


def test_lcp_parse_and_apply_match(tmp_path):
    p = str(tmp_path / "lens.lcp")
    with open(p, "w") as f:
        f.write(_LCP_SAMPLE)
    pj, pt = jlcp.parse_lcp(p), tlcp.parse_lcp(p)
    assert (pt.camera, pt.lens) == (pj.camera, pj.lens) == ("TestCam X1", "Test 24-70mm")
    for fmm in (10.0, 24.0, 47.0, 70.0, 90.0):
        assert vars(pt.interpolate(fmm)) == vars(pj.interpolate(fmm))
    alt = tlcp.LcpAlternate(focal_mm=24.0, focal_x=0.7, focal_y=0.7, cx=0.5, cy=0.5, radial=(-0.15, 0.02, 0.0),
                            vignette=(-0.6, 0.1, 0.0))
    for img in (_img((60, 80)), _img((60, 80, 3))):
        for tf, jf in ((tproc.apply_lcp_vignette, jproc.apply_lcp_vignette),
                       (tproc.apply_lcp_geometry, jproc.apply_lcp_geometry)):
            np.testing.assert_allclose(tf(torch.from_numpy(img), alt).numpy(), np.asarray(jf(jnp.asarray(img), alt)),
                                       atol=ATOL)
    no_vig = tlcp.LcpAlternate()
    x = torch.from_numpy(_img((8, 8)))
    assert tproc.apply_lcp_vignette(x, no_vig) is x


def test_dcp_parse_and_apply_match():
    pj, pt = jdcp.DCPProfile.from_xml(_DCP_XML), tdcp.DCPProfile.from_xml(_DCP_XML)
    assert pt.name == pj.name == "Test Cam"
    for cct in (2856.0, 4000.0, 5000.0, 6500.0):
        assert np.array_equal(pt.camera_to_srgb_matrix(cct), pj.camera_to_srgb_matrix(cct))
    img = _img((12, 16, 3))
    np.testing.assert_allclose(pt.apply(img, cct=4500.0).numpy(), np.asarray(pj.apply(img, cct=4500.0)), atol=ATOL)
    curve = np.array([[0.0, 0.0], [0.25, 0.4], [0.6, 0.8], [1.0, 1.0]])
    pj.tone_curve = pt.tone_curve = curve
    np.testing.assert_allclose(pt.apply(img * 1.5 - 0.2, apply_tone_curve=True).numpy(),
                               np.asarray(pj.apply(img * 1.5 - 0.2, apply_tone_curve=True)), atol=ATOL)
