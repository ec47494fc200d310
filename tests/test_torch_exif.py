"""The port's EXIF reader (`image/exif.py`, behind `image/io.read_exif`)
against the JAX package's `read_exif` (PIL's `getexif()`).

On files that hold FocalLength in IFD0 (the JAX photo test's form, PIL's
own writer, and the port's builder in both byte orders) the two return
the same dict. Cameras write FocalLength in the Exif sub-IFD: there the
port reads it, as the reference does through OIIO, and the JAX function
does not (ROADMAP §3, repaired in the port only).
"""

import io
import json
import os
import warnings

import numpy as np
import pytest
from PIL import Image

from alicevision_tpu.image import io as jio
from alicevision_tpu_torch.image import exif, jpeg
from alicevision_tpu_torch.image import io as tio

MAKE, MODEL = "Canon", "Canon EOS 5D Mark III"
FIXTURES = os.path.join(os.path.dirname(jpeg.__file__), "..", "data", "jpeg_fixtures")


def _base(h=9, w=7) -> bytes:
    rng = np.random.default_rng(h * w)
    return jpeg.encode((rng.random((h, w, 3)) * 255).astype(np.uint8), 90)


def _write(tmp_path, name: str, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _pil_ifd0(focal_mm: float) -> bytes:
    """The JAX photo test's writer: PIL's Image.Exif with the three tags
    in IFD0 (PIL writes MM and the focal as a DOUBLE)."""
    e = Image.Exif()
    e[271], e[272], e[37386] = MAKE, MODEL, focal_mm
    b = io.BytesIO()
    Image.fromarray(np.full((24, 32, 3), 90, np.uint8)).save(b, format="JPEG", quality=95, exif=e)
    return b.getvalue()


@pytest.mark.parametrize("writer", ["pil", "II", "MM"])
def test_ifd0_matches_jax(tmp_path, writer):
    for focal in (25.3125, 31.5, 50.0):
        if writer == "pil":
            data = _pil_ifd0(focal)
        else:
            data = exif.insert_app1(_base(), exif.exif_app1(MAKE, MODEL, focal, writer, "ifd0"))
        path = _write(tmp_path, f"{writer}_{focal}.jpg", data)
        got, ref = tio.read_exif(path), jio.read_exif(path)
        assert got == ref and got["focal_mm"] == pytest.approx(focal), (got, ref)


@pytest.mark.parametrize("order", ["II", "MM"])
def test_sub_ifd_focal_read_by_the_port_only(tmp_path, order):
    """FocalLength in the Exif sub-IFD, where cameras write it: the port
    reads it; the JAX function (IFD0 only) returns no focal."""
    path = _write(tmp_path, "cam.jpeg", exif.insert_app1(_base(17, 33), exif.exif_app1(MAKE, MODEL, 31.5, order)))
    got, ref = tio.read_exif(path), jio.read_exif(path)
    assert got == {"width": 33, "height": 17, "make": MAKE, "model": MODEL, "focal_mm": 31.5}
    assert "focal_mm" not in ref and {k: got[k] for k in ref} == ref


def test_strings_and_unreadable_app1_match_jax(tmp_path):
    """Padding (a NUL PIL keeps, spaces both strip) as JAX reads it, and an
    APP1 that cannot be parsed gives the dimensions alone in both."""
    base = _base()
    good = exif.exif_app1("Canon\0", " M  ", 31.5, "II", "ifd0")
    bad_ptr = bytearray(exif.exif_app1(MAKE, MODEL, 31.5, "II", "ifd0"))
    at = bad_ptr.index(b"II*\0") + 8 + 2 + 8  # the first entry's value offset
    bad_ptr[at:at + 4] = (60000).to_bytes(4, "little")
    cases = {"padded": good, "pointer": bytes(bad_ptr), "order": good.replace(b"II*\0", b"XX*\0"),
             "short": good[:24]}
    for name, app1 in cases.items():
        if name == "short":  # a segment cut inside its TIFF header, length fixed up
            app1 = app1[:2] + len(app1[2:]).to_bytes(2, "big") + app1[4:]
        path = _write(tmp_path, f"{name}.jpg", exif.insert_app1(base, app1))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # PIL warns of the corrupt segments
            ref = jio.read_exif(path)
        assert tio.read_exif(path) == ref, name
        if name != "padded":
            assert ref == {"width": 7, "height": 9}, name


def test_png_and_npy_dimensions_match_jax(tmp_path):
    img = (np.random.default_rng(0).random((13, 21, 3)) * 255).astype(np.uint8)
    png, npy = str(tmp_path / "a.png"), str(tmp_path / "a.npy")
    tio.write_png(png, img)
    np.save(npy, img.astype(np.float32) / 255)
    for path in (png, npy):
        assert tio.read_exif(path) == jio.read_exif(path) == {"width": 21, "height": 13}


def test_fixtures_exif_and_sizes():
    """Every committed fixture: the port's read_exif against the EXIF and
    shape PIL read when it was written (scripts/make_jpeg_fixtures.py)."""
    with open(os.path.join(FIXTURES, "fixtures.json")) as f:
        table = json.load(f)
    with_focal = 0
    for name, row in table.items():
        meta = tio.read_exif(os.path.join(FIXTURES, name))
        assert (meta.pop("height"), meta.pop("width")) == tuple(row["shape"][:2]), name
        assert meta == row["exif"], name
        with_focal += "focal_mm" in meta
    assert with_focal == 4
