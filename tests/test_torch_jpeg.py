"""The port's JPEG codec (`image/jpeg.py` over `native/jpeg.cpp`) against
the JAX package's reader (imageio, that is libjpeg-turbo through PIL) and
against its own plain version.

The images are seeded numpy photographs-alike (smooth colour waves with
noise), written in the test by PIL and by `cv2.imencode` (4:4:0, which
PIL does not write). The decoder is byte-equal to
`alicevision_tpu.image.io.read_image` on every variant: libjpeg-turbo's
islow IDCT, fancy upsampling and colour tables are integer arithmetic.
The encoder writes PIL's entropy-coded bytes at the same quality and
subsampling.
"""

import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image, ImageFile

from alicevision_tpu.image import io as jio
from alicevision_tpu_torch.image import io as tio
from alicevision_tpu_torch.image import jpeg

SIZES = [(1, 1), (9, 7), (33, 17), (961, 1283)]  # (H, W): 1x1, 7x9, 17x33, 1283x961
QUALITIES = [50, 75, 95, 100]
SUBSAMPLINGS = ["4:4:4", "4:2:2", "4:2:0", "4:4:0", "grey"]
MODES = ["baseline", "optimize", "progressive", "restart"]
ImageFile.MAXBLOCK = 1 << 24  # PIL's optimize/progressive writers buffer whole files of 1283x961
FIXTURES = os.path.join(os.path.dirname(jpeg.__file__), "..", "data", "jpeg_fixtures")


def photo(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A seeded RGB uint8 image with photograph-like content: colour waves
    and sensor-like noise."""
    rng = np.random.default_rng(seed + 7919 * h + w)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7 + c) * np.cos(y / 5 - c) for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def make_jpeg(img: np.ndarray, subsampling: str, mode: str, quality: int) -> bytes:
    """PIL's file for every subsampling but 4:4:0, which cv2 writes."""
    if subsampling == "grey":
        img = img[..., 1]
    if subsampling == "4:4:0":
        import cv2

        flags = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x121111,
                 cv2.IMWRITE_JPEG_OPTIMIZE, int(mode == "optimize"),
                 cv2.IMWRITE_JPEG_PROGRESSIVE, int(mode == "progressive"),
                 cv2.IMWRITE_JPEG_RST_INTERVAL, 3 if mode == "restart" else 0]
        ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]), flags)
        assert ok
        return buf.tobytes()
    kw = dict(quality=quality)
    if subsampling != "grey":
        kw["subsampling"] = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}[subsampling]
    if mode in ("optimize", "progressive"):
        kw[mode] = True
    if mode == "restart":
        kw["restart_marker_blocks"] = 3
    b = io.BytesIO()
    Image.fromarray(img).save(b, format="JPEG", **kw)
    return b.getvalue()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("subsampling", SUBSAMPLINGS)
def test_read_image_matches_jax(tmp_path, subsampling, mode):
    """Every quality and size of one (subsampling, mode) variant: the port's
    read_image byte-equal to the JAX package's, grey as (H, W) and colour
    as (H, W, 3), and with grayscale=True."""
    for h, w in SIZES:
        for q in QUALITIES:
            path = str(tmp_path / f"{h}x{w}_q{q}.jpg")
            with open(path, "wb") as f:
                f.write(make_jpeg(photo(h, w), subsampling, mode, q))
            ref, got = jio.read_image(path), tio.read_image(path)
            assert got.dtype == ref.dtype and got.shape == ref.shape, (h, w, q)
            np.testing.assert_array_equal(got, ref, err_msg=f"{h}x{w} q{q}")
            if (h, w) == (33, 17):
                np.testing.assert_array_equal(tio.read_image(path, grayscale=True),
                                              jio.read_image(path, grayscale=True))


PLAIN_CASES = [("4:2:0", "baseline", 75), ("4:2:2", "restart", 95), ("4:4:4", "progressive", 50),
               ("4:4:0", "progressive", 90), ("grey", "optimize", 100), ("4:2:0", "progressive", 95),
               ("4:4:0", "restart", 75), ("grey", "progressive", 75)]


@pytest.mark.parametrize("subsampling,mode,quality", PLAIN_CASES)
def test_decode_matches_plain(subsampling, mode, quality):
    """The C++ entropy decoder and pixel stage byte-equal to the Python and
    numpy plain version, on odd sizes (partial MCUs) and one of 64x48."""
    for h, w in [(9, 7), (33, 17), (48, 64)]:
        data = make_jpeg(photo(h, w, seed=1), subsampling, mode, quality)
        np.testing.assert_array_equal(jpeg.decode(data), jpeg.decode_plain(data), err_msg=f"{h}x{w}")


@pytest.mark.parametrize("grey", [False, True])
def test_encode_matches_plain(grey):
    """The C++ encoder byte-equal to its numpy plain version, noise at
    quality 100 included (more bytes than samples)."""
    for h, w in [(1, 1), (9, 7), (33, 17), (48, 64)]:
        img = photo(h, w, seed=2)
        if grey:
            img = img[..., 0]
        for q in (50, 75, 95, 100):
            assert jpeg.encode(img, q) == jpeg.encode_plain(img, q), (h, w, q)
    noise = (np.random.default_rng(5).random((40, 56, 3)) * 255).astype(np.uint8)
    noise = noise[..., 0] if grey else noise
    assert jpeg.encode(noise, 100) == jpeg.encode_plain(noise, 100)


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0**2 / mse))


@pytest.mark.parametrize("subsampling", ["4:2:0", "grey"])
def test_encode_against_pil(subsampling):
    """PIL reads the port's file; its PSNR against the source is within
    0.05 dB of PIL's own file at the same quality and subsampling (in fact
    the entropy-coded data is PIL's, byte for byte)."""
    for h, w in [(9, 7), (33, 17), (240, 320)]:
        img = photo(h, w, seed=3)
        if subsampling == "grey":
            img = img[..., 2]
        for q in (50, 75, 95, 100):
            ours = jpeg.encode(img, q)
            theirs = make_jpeg(np.dstack([img] * 3) if img.ndim == 2 else img,
                               subsampling, "baseline", q)
            dec = np.asarray(Image.open(io.BytesIO(ours)))
            assert dec.shape == img.shape
            np.testing.assert_array_equal(dec, jpeg.decode(ours))
            ref = np.asarray(Image.open(io.BytesIO(theirs)))
            assert abs(_psnr(dec, img) - _psnr(ref, img)) <= 0.05 or _psnr(dec, img) == _psnr(ref, img), (h, w, q)
            assert ours[ours.index(b"\xff\xda"):] == theirs[theirs.index(b"\xff\xda"):], (h, w, q)


def test_write_image_matches_jax(tmp_path):
    """write_image on `.jpg`: the JAX package (imageio at PIL's defaults)
    and the port write files that decode to the same pixels, from float
    and from uint8, colour and grey."""
    img = photo(61, 83, seed=4)
    for name, arr in [("rgb_f", img.astype(np.float32) / 255), ("rgb_u8", img),
                      ("grey_f", img[..., 0].astype(np.float32) / 255), ("grey_u8", img[..., 1])]:
        a, b = str(tmp_path / f"{name}_jax.jpg"), str(tmp_path / f"{name}_port.jpeg")
        jio.write_image(a, arr)
        tio.write_image(b, arr)
        np.testing.assert_array_equal(tio.read_image(b), jio.read_image(a), err_msg=name)


def _rewrite_tables(data: bytes) -> bytes:
    """`data` with every DQT table rewritten at 16-bit precision (Pq = 1,
    the same values) and all DHT tables merged into one segment: the same
    image, in table forms PIL does not write."""
    pos, head, dht = 2, [b"\xff\xd8"], b""
    while data[pos + 1] != 0xDA:
        marker = data[pos + 1]
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        body = data[pos + 4:pos + 2 + n]
        if marker == 0xDB:
            out = b""
            for k in range(0, len(body), 65):
                out += bytes([0x10 | (body[k] & 15)]) + b"".join(v.to_bytes(2, "big") for v in body[k + 1:k + 65])
            head.append(b"\xff\xdb" + (len(out) + 2).to_bytes(2, "big") + out)
        elif marker == 0xC4:
            dht += body
        else:
            head.append(data[pos:pos + 2 + n])
        pos += 2 + n
    head.append(b"\xff\xc4" + (len(dht) + 2).to_bytes(2, "big") + dht)
    return b"".join(head) + data[pos:]


def test_sixteen_bit_quantizers_and_merged_huffman_tables():
    for subsampling, mode in (("4:2:0", "baseline"), ("4:2:2", "progressive"), ("grey", "restart")):
        data = make_jpeg(photo(33, 17), subsampling, mode, 75)
        other = _rewrite_tables(data)
        assert other != data and jpeg.parse(other)["quant"].shape[1] == 64
        ref = np.asarray(Image.open(io.BytesIO(data)))
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(other))), ref)
        np.testing.assert_array_equal(jpeg.decode(other), ref)
        np.testing.assert_array_equal(jpeg.decode_plain(other), ref)


def _segment_offsets(data: bytes, marker: int) -> int:
    return data.index(bytes([0xFF, marker]))


def test_refusals_name_the_marker():
    """What libjpeg-turbo decodes and this codec does not take raises a
    ValueError that names it."""
    base = make_jpeg(photo(17, 33), "4:2:0", "baseline", 75)
    sof = _segment_offsets(base, 0xC0)
    sos = _segment_offsets(base, 0xDA)
    prog = make_jpeg(photo(17, 33), "4:2:0", "progressive", 75)
    cut = prog.rindex(b"\xff\xc4")  # drop the last scan(s)
    b = io.BytesIO()
    Image.new("CMYK", (16, 8), (10, 20, 30, 40)).save(b, format="JPEG")
    cases = [
        (r"lossless \(SOF3\)", base[:sof + 1] + b"\xc3" + base[sof + 2:]),
        (r"hierarchical \(SOF5\)", base[:sof + 1] + b"\xc5" + base[sof + 2:]),
        (r"arithmetic coding \(SOF9\)", base[:sof + 1] + b"\xc9" + base[sof + 2:]),
        (r"12-bit samples", base[:sof + 4] + b"\x0c" + base[sof + 5:]),
        (r"truncated", base[:len(base) // 2]),
        (r"truncated scan", base[:sos + 30] + b"\xff\xd9"),
        (r"4 components \(CMYK/YCCK\)", b.getvalue()),
        (r"incomplete", prog[:cut] + b"\xff\xd9"),
    ]
    for pattern, data in cases:
        for fn in (jpeg.decode, jpeg.decode_plain):
            with pytest.raises(ValueError, match=pattern):
                fn(data)


def test_fixtures_match_pil():
    """The committed fixtures (scripts/make_jpeg_fixtures.py) still decode
    to the SHA-256 PIL gave when they were written, in PIL, in the C++ and
    in the plain decoder: the card's oracle cannot rot."""
    with open(os.path.join(FIXTURES, "fixtures.json")) as f:
        table = json.load(f)
    assert len(table) >= 10
    total = 0
    for name, row in table.items():
        path = os.path.join(FIXTURES, name)
        total += os.path.getsize(path)
        with open(path, "rb") as f:
            data = f.read()
        pil = np.asarray(Image.open(path))
        assert list(pil.shape) == row["shape"], name
        for got in (pil, jpeg.decode(data), jpeg.decode_plain(data)):
            assert hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest() == row["sha256"], name
    assert total < 100_000
