"""The port's TIFF reader and writer (`image/tiff.py` over
`native/codecs.cpp`) and a TIFF's EXIF (`image/exif.read_tiff_exif`)
against the JAX package's `read_image` / `write_image` / `read_exif`
(imageio's bundled tifffile and PIL).

The fixtures are `alicevision_tpu_torch/data/codec_fixtures/tif_*.tif`
(`scripts/make_codec_fixtures.py`: Pillow, cv2 / libtiff and tifffile
files, and the script's own encoders for the rest). Every fixture reads
equal through the port's C++ and plain routes and the JAX package, but
two recorded partings: PlanarConfiguration 2, which imageio returns as
(S, H, W) and the port as (H, W, S), as OIIO does; and FocalLength in the
Exif sub-IFD, which PIL's `getexif()` misses and the port reads.
"""

import importlib.util
import json
import os
import warnings

import numpy as np
import pytest

from alicevision_tpu.image import io as jio
from alicevision_tpu_torch import native
from alicevision_tpu_torch.image import exif, tiff
from alicevision_tpu_torch.image import io as tio

FIXTURES = os.path.join(os.path.dirname(tiff.__file__), "..", "data", "codec_fixtures")
TABLE = json.load(open(os.path.join(FIXTURES, "fixtures.json")))
TIFS = sorted(n for n in TABLE if n.endswith(".tif") and "raises" not in TABLE[n].get("port", {}))
REFUSED = sorted(n for n in TABLE if n.endswith(".tif") and "raises" in TABLE[n].get("port", {}))


def make_fixtures():
    """scripts/make_codec_fixtures.py as a module (its encoders)."""
    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "make_codec_fixtures.py")
    spec = importlib.util.spec_from_file_location("make_codec_fixtures", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax(fn, *a):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a)


@pytest.mark.parametrize("name", TIFS)
def test_fixture_matches_jax(name):
    """C++ and plain decodes equal; read_image equal to the JAX package's
    (planar files: the JAX image is the port's with its axes moved)."""
    path = os.path.join(FIXTURES, name)
    got = tiff.read_tiff(path)
    np.testing.assert_array_equal(tiff.read_tiff(path, plain=True), got)
    ours, ref = tio.read_image(path), _jax(jio.read_image, path)
    assert ours.dtype == ref.dtype == np.float32
    if "planar" in name:
        assert ref.shape == (got.shape[2],) + got.shape[:2]  # JAX: (S, H, W), an image S pixels high
        np.testing.assert_array_equal(np.moveaxis(ref, 0, -1), ours)
    else:
        np.testing.assert_array_equal(ours, ref)
    if ours.ndim == 3 and ours.shape[2] >= 3 and "planar" not in name:
        np.testing.assert_array_equal(tio.read_image(path, True), _jax(jio.read_image, path, True))


@pytest.mark.parametrize("name", REFUSED)
def test_refused_fixtures_name_the_variant(name):
    with pytest.raises(ValueError, match=TABLE[name]["port"]["raises"].replace("(", r"\(").replace(")", r"\)")):
        tio.read_image(os.path.join(FIXTURES, name))


@pytest.mark.parametrize("order", ["ii", "mm"])
def test_exif_ifd0_and_sub_ifd(order):
    """IFD0: the port's read_exif equals the JAX package's. Exif sub-IFD:
    the port reads the focal, the JAX function (PIL's IFD0) does not."""
    p0 = os.path.join(FIXTURES, f"tif_exif_ifd0_{order}.tif")
    assert tio.read_exif(p0) == _jax(jio.read_exif, p0) == {
        "width": 12, "height": 9, "make": "Canon", "model": "Canon EOS 5D Mark III", "focal_mm": 31.5}
    ps = os.path.join(FIXTURES, f"tif_exif_exif_{order}.tif")
    got, ref = tio.read_exif(ps), _jax(jio.read_exif, ps)
    assert got["focal_mm"] == 31.5 and "focal_mm" not in ref
    assert {k: got[k] for k in ref} == ref
    for name in TIFS:
        p = os.path.join(FIXTURES, name)
        want = TABLE[name].get("port", {}).get("exif", TABLE[name]["jax"]["exif"])
        assert tio.read_exif(p) == want, name


def test_lzw_and_packbits_cpp_equal_plain():
    """The C++ against the plain decoders: the fixtures' strips and tiles,
    and the script's encoder on data that fills the table (Clear codes),
    repeats (KwKwK codes) and is empty."""
    mk = make_fixtures()
    rng = np.random.default_rng(0)
    blobs = [b"", b"a", b"aaaaaaaaaaaaaaaa", bytes(rng.integers(0, 256, 9000, np.uint8)),
             bytes(rng.integers(0, 4, 20000, np.uint8)), bytes(np.repeat(rng.integers(0, 256, 700, np.uint8), 5))]
    for data in blobs:
        enc = mk.lzw_encode(data)
        assert bytes(native.lzw_decode(enc, len(data))) == tiff._lzw_decode_plain(enc, len(data)) == data
        assert bytes(native.lzw_decode(enc, len(data) // 2)) == data[:len(data) // 2]
        pb = mk.packbits_encode(data)
        assert bytes(native.packbits_decode(pb, len(data))) == tiff._packbits_plain(pb, len(data)) == data
    with open(os.path.join(FIXTURES, "lzw_strip.tif"), "rb") as f:
        data = f.read()
    bo, off = tiff.tiff_header(data)
    tags = exif._ifd(data, off, bo)
    strip = data[tags[tiff.STRIP_OFFSETS]:tags[tiff.STRIP_OFFSETS] + tags[tiff.STRIP_COUNTS]]
    n = 6000 * 4 * 3 * 2
    assert bytes(native.lzw_decode(strip, n)) == tiff._lzw_decode_plain(strip, n)
    with pytest.raises(ValueError, match="old-style"):
        native.lzw_decode(b"\0\1\2", 10)


def test_cpp_equals_plain_on_garbage():
    """Random bytes (outside input) through the C++ and the plain LZW and
    PackBits decoders: the same bytes out, or a ValueError from both."""
    rng = np.random.default_rng(7)

    def run(fn, data, cap):
        try:
            return bytes(fn(data, cap))
        except ValueError:
            return "raises"

    for _ in range(300):
        data = bytes(rng.integers(0, 256, int(rng.integers(0, 400)), np.uint8))
        if rng.random() < 0.5:
            data = b"\x80" + data  # a Clear code first, as encoders write
        cap = int(rng.integers(0, 3000))
        assert run(native.lzw_decode, data, cap) == run(tiff._lzw_decode_plain, data, cap)
        assert run(native.packbits_decode, data, cap) == run(tiff._packbits_plain, data, cap)


@pytest.mark.parametrize("shape,dtype", [((6, 9), np.uint8), ((6, 9, 3), np.uint8), ((6, 9, 4), np.uint8),
                                         ((6, 9), np.uint16), ((6, 9, 3), np.uint16), ((6, 9, 4), np.uint16)])
def test_write_read_through_imageio(tmp_path, shape, dtype):
    """The port's files read back equal through imageio, imageio's through
    the port, and write_image's float path as the JAX package's."""
    import imageio.v2 as imageio

    rng = np.random.default_rng(1)
    img = (rng.random(shape) * np.iinfo(dtype).max).astype(dtype)
    tio.write_image(str(tmp_path / "port.tif"), img)
    np.testing.assert_array_equal(_jax(imageio.imread, tmp_path / "port.tif"), img)
    imageio.imwrite(tmp_path / "iio.tif", img)
    np.testing.assert_array_equal(tiff.read_tiff(str(tmp_path / "iio.tif")), img)
    f = rng.random(shape[:2] + shape[2:]).astype(np.float32)
    tio.write_image(str(tmp_path / "pf.tif"), f)
    jio.write_image(str(tmp_path / "jf.tif"), f)
    np.testing.assert_array_equal(tio.read_image(str(tmp_path / "pf.tif")),
                                  _jax(jio.read_image, str(tmp_path / "jf.tif")))


def test_refused_variants(tmp_path):
    """Variants the reader does not take raise ValueError naming them."""
    base = tiff.tiff_bytes(np.zeros((4, 5), np.uint8))
    bo, off = tiff.tiff_header(base)

    def patched(tag: int, value: int) -> bytes:
        out = bytearray(base)
        (n,) = np.frombuffer(base[off:off + 2], "<u2")
        for i in range(n):
            e = off + 2 + 12 * i
            if int.from_bytes(base[e:e + 2], "little") == tag:
                out[e + 8:e + 10] = value.to_bytes(2, "little")
        return bytes(out)

    for tag, value, msg in ((259, 7, r"compression 7 \(JPEG\)"), (259, 34712, "JPEG 2000"),
                            (258, 1, r"BitsPerSample \[1\]"), (339, 2, r"SampleFormat \[2\]"),
                            (262, 5, "PhotometricInterpretation 5"), (317, 3, "Predictor 3 for uint8")):
        data = patched(tag, value) if tag != 317 else tiff.assemble(5, 4, 1, 8, [bytes(20)], 4, predictor=3)
        with pytest.raises(ValueError, match=msg):
            tiff.decode_tiff(data)
    with pytest.raises(ValueError, match="BigTIFF"):
        tiff.decode_tiff(b"II+\0" + base[4:])
