"""The port's PNG and BMP readers and writers (`image/png.py` over
`native/codecs.cpp`, `image/bmp.py`) against the JAX package's
`read_image` / `write_image` / `read_exif` (imageio, that is Pillow).

The fixtures are `alicevision_tpu_torch/data/codec_fixtures/{png,bmp}_*`
(`scripts/make_codec_fixtures.py`): every PNG bit depth and colour type,
palettes, tRNS and Adam7 with every row filter; BMP palettes of 1, 4 and 8
bits, RLE8 and RLE4, 24 and 32 bits raw and BI_BITFIELDS, top-down rows,
and the V4 and V5 headers. Each reads equal to the JAX package but the
recorded parting: a 16-bit RGB or RGBA PNG keeps its 16 bits in the port
(as OIIO reads it), where Pillow keeps the high byte.
"""

import json
import os
import warnings

import numpy as np
import pytest

from alicevision_tpu.image import io as jio
from alicevision_tpu_torch import native
from alicevision_tpu_torch.image import bmp, png
from alicevision_tpu_torch.image import io as tio

FIXTURES = os.path.join(os.path.dirname(png.__file__), "..", "data", "codec_fixtures")
TABLE = json.load(open(os.path.join(FIXTURES, "fixtures.json")))
PNGS = sorted(n for n in TABLE if n.endswith(".png"))
BMPS = sorted(n for n in TABLE if n.endswith(".bmp") and "raises" not in TABLE[n].get("port", {}))
WIDE = {n for n in PNGS if "port" in TABLE[n]}  # the 16-bit RGB / RGBA files


def _jax(fn, *a):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a)


@pytest.mark.parametrize("name", PNGS)
def test_png_fixture_matches_jax(name):
    """C++ and plain unfilters equal; read_image and read_exif equal to the
    JAX package's; where 16 bits part, the JAX image is the port's high
    byte."""
    import imageio.v2 as imageio

    path = os.path.join(FIXTURES, name)
    got = png.read_png(path)
    np.testing.assert_array_equal(png.read_png(path, plain=True), got)
    assert tio.read_exif(path) == _jax(jio.read_exif, path)
    ours, ref = tio.read_image(path), _jax(jio.read_image, path)
    if name not in WIDE:
        np.testing.assert_array_equal(ours, ref)
        return
    raw = _jax(imageio.imread, path)
    assert got.dtype == np.uint16 and raw.dtype == np.uint8
    np.testing.assert_array_equal(raw, (got >> 8).astype(np.uint8))
    assert np.abs(ours - ref).max() <= 1 / 255  # the low byte is what JAX loses


@pytest.mark.parametrize("name", ["png_la16.png", "png_rgb16.png", "png_rgba16.png", "png_g16.png"])
def test_png_16_bit_grayscale_matches_jax(name):
    """read_image(grayscale=True) of the 16-bit PNGs: equal to the JAX
    package's (16-bit grey + alpha read as Pillow's RGBA) to 1e-6, the
    float32 dot's rounding, which numpy's matmul varies with the array's
    alignment; within the low byte where the port keeps 16 bits."""
    path = os.path.join(FIXTURES, name)
    ours, ref = tio.read_image(path, grayscale=True), _jax(jio.read_image, path, True)
    assert ours.shape == ref.shape == (11, 13)
    if name in WIDE:
        assert np.abs(ours - ref).max() <= 1 / 255
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", BMPS)
def test_bmp_fixture_matches_jax(name):
    path = os.path.join(FIXTURES, name)
    np.testing.assert_array_equal(tio.read_image(path), _jax(jio.read_image, path))
    assert tio.read_exif(path) == _jax(jio.read_exif, path)


def test_bmp_16bit_refused():
    with pytest.raises(ValueError, match="BMP 16-bit"):
        tio.read_image(os.path.join(FIXTURES, "bmp_16bit.bmp"))


def test_unfilter_cpp_equals_plain():
    """Random rows under every filter at every pixel step."""
    rng = np.random.default_rng(0)
    for bpp in range(1, 9):
        h, stride = 7, 5 * bpp
        raw = rng.integers(0, 256, (h, stride + 1), np.uint8)
        raw[:, 0] = np.arange(h) % 5
        np.testing.assert_array_equal(native.png_unfilter(raw, h, stride, bpp), png._unfilter(raw, h, stride, bpp))
    raw[3, 0] = 9
    for fn in (native.png_unfilter, png._unfilter):
        with pytest.raises(ValueError, match="row filter 9"):
            fn(raw, h, stride, bpp)


@pytest.mark.parametrize("kind", ["grey", "bool", "rgb", "rgba"])
def test_bmp_writer_is_pillows(tmp_path, kind):
    """write_image's BMP bytes equal imageio's (Pillow's) for the JAX
    write_image's inputs (bool: Pillow's own, imageio takes none), and read
    back equal both ways."""
    import imageio.v2 as imageio
    from PIL import Image

    rng = np.random.default_rng(2)
    shape = {"grey": (7, 10), "bool": (7, 10), "rgb": (7, 10, 3), "rgba": (7, 10, 4)}[kind]
    img = rng.integers(0, 256, shape).astype(np.uint8)
    if kind == "bool":
        img = img > 127
    tio.write_image(str(tmp_path / "p.bmp"), img)
    if kind == "bool":
        Image.fromarray(img).save(tmp_path / "j.bmp")
    else:
        imageio.imwrite(tmp_path / "j.bmp", img)
    assert (tmp_path / "p.bmp").read_bytes() == (tmp_path / "j.bmp").read_bytes()
    want = img[..., :3] if kind == "rgba" else img  # Pillow reads 32-bit BI_RGB as RGB
    np.testing.assert_array_equal(bmp.read_bmp(str(tmp_path / "j.bmp")), want)
    f = rng.random(shape[:2]).astype(np.float32)
    tio.write_image(str(tmp_path / "pf.bmp"), f)
    jio.write_image(str(tmp_path / "jf.bmp"), f)
    assert (tmp_path / "pf.bmp").read_bytes() == (tmp_path / "jf.bmp").read_bytes()


def test_png_writer_16_bit(tmp_path):
    """16-bit grey round trips through imageio; 16-bit RGB (which imageio
    cannot write) through cv2, which keeps 16 bits."""
    import cv2
    import imageio.v2 as imageio

    rng = np.random.default_rng(3)
    g = rng.integers(0, 65536, (5, 8)).astype(np.uint16)
    tio.write_image(str(tmp_path / "g.png"), g)
    np.testing.assert_array_equal(_jax(imageio.imread, tmp_path / "g.png"), g)
    rgb = rng.integers(0, 65536, (5, 8, 3)).astype(np.uint16)
    tio.write_image(str(tmp_path / "c.png"), rgb)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "c.png"), cv2.IMREAD_UNCHANGED)[..., ::-1], rgb)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "c.png")), rgb)
