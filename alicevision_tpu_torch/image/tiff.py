"""TIFF reader and writer of the port, with no image codec library.

Counterpart of the TIFF half of `alicevision_tpu/image/io.py`, which reads
`.tif` / `.tiff` through imageio (its bundled tifffile) and writes them
through `imageio.imwrite`. `decode_tiff` reads a classic TIFF's first
image (IFD0), in either byte order (II, MM):

- SamplesPerPixel 1 to 4 (ExtraSamples, such as alpha, come out as
  channels), BitsPerSample 8 and 16 (SampleFormat 1, unsigned) and 32-bit
  float (SampleFormat 3);
- PhotometricInterpretation 0 (WhiteIsZero), 1 (BlackIsZero), 2 (RGB)
  and 3 (palette), each as imageio gives it: the stored values, with no
  inversion of WhiteIsZero and a palette image as its indices;
- Compression 1 (none), 5 (LZW), 8 and 32946 (deflate, through the
  standard library's zlib) and 32773 (PackBits);
- Predictor 2 (horizontal differences, undone with a cumulative sum at the
  sample's own width, wrapping as the dtype does) and 3 (floating point);
- strips and tiles, PlanarConfiguration 1 and 2.

It returns (H, W) for one sample and (H, W, S) for more, uint8, uint16 or
float32. One parting: for PlanarConfiguration 2 imageio returns (S, H, W),
which the JAX `read_image` passes on as an image S pixels high; the port
returns (H, W, S), as the reference's OIIO does (ROADMAP §3). Any other
variant raises a ValueError naming it ("TIFF compression 7 (JPEG)",
"BigTIFF", ...).

The LZW and PackBits loops run in `native/codecs.cpp`
(`native.lzw_decode`, `native.packbits_decode`); `_lzw_decode_plain` and
`_packbits_plain` are their plain Python versions (`decode_tiff(...,
plain=True)`). `write_tiff` writes what `imageio.imwrite` writes for the
JAX `write_image`: a baseline, uncompressed TIFF of uint8 or uint16 grey,
grey + alpha, RGB or RGBA, in one strip. `assemble` packs a TIFF from
already-encoded strips and optional EXIF tags (test code builds its
compressed files with it).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .. import native
from . import exif
from .exif import HEIGHT, WIDTH, tiff_header

BITS, COMPRESSION, PHOTOMETRIC = 258, 259, 262
STRIP_OFFSETS, SPP, ROWS_PER_STRIP, STRIP_COUNTS, PLANAR = 273, 277, 278, 279, 284
PREDICTOR, TILE_W, TILE_H, TILE_OFFSETS, TILE_COUNTS = 317, 322, 323, 324, 325
EXTRA_SAMPLES, SAMPLE_FORMAT = 338, 339
_TAKEN = {1: "none", 5: "LZW", 8: "deflate", 32946: "deflate", 32773: "PackBits"}
_NOT_TAKEN = {2: "CCITT RLE", 3: "CCITT G3", 4: "CCITT G4", 6: "old JPEG", 7: "JPEG", 34661: "JBIG",
              34712: "JPEG 2000", 34925: "LZMA", 50000: "Zstandard", 50001: "WebP", 32809: "ThunderScan"}
_PHOTOMETRIC = {0: "WhiteIsZero", 1: "BlackIsZero", 2: "RGB", 3: "palette"}
_DTYPES = {(1, 8): np.uint8, (1, 16): np.uint16, (3, 32): np.float32}


def _tuple(v) -> tuple:
    return v if isinstance(v, tuple) else (v,)


def _lzw_decode_plain(data: bytes, size: int) -> bytes:
    """TIFF LZW (MSB-first codes of 9 to 12 bits, Clear 256, EOI 257, the
    width growing one code early), at most `size` bytes: the plain version
    of `native.lzw_decode`."""
    if len(data) >= 2 and data[0] == 0 and data[1] & 1:
        raise ValueError("TIFF old-style (LSB-first) LZW is not taken")
    bits = int.from_bytes(data, "big")
    nbits, pos = 8 * len(data), 0
    out = bytearray()
    table, width, prev = None, 9, None
    while len(out) < size and pos + width <= nbits:
        code = (bits >> (nbits - pos - width)) & ((1 << width) - 1)
        pos += width
        if code == 256:
            table, width, prev = [bytes([i]) for i in range(256)] + [b"", b""], 9, None
            continue
        if code == 257:
            break
        if table is None:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
        if prev is None:
            if code > 255:
                raise ValueError("TIFF LZW: a code past the table")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                new = prev + entry[:1]
            elif code == len(table) < 4096:
                new = entry = prev + prev[:1]
            else:
                raise ValueError("TIFF LZW: a code past the table")
            if len(table) < 4096:
                table.append(new)
        out += entry
        prev = entry
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
    return bytes(out[:size])


def _packbits_plain(data: bytes, size: int) -> bytes:
    """PackBits, at most `size` bytes: the plain version of
    `native.packbits_decode`."""
    out, pos = bytearray(), 0
    while pos < len(data) and len(out) < size:
        h = data[pos] - 256 if data[pos] > 127 else data[pos]
        pos += 1
        if h >= 0:
            out += data[pos:pos + h + 1]
            pos += h + 1
        elif h != -128 and pos < len(data):
            out += data[pos:pos + 1] * (1 - h)
            pos += 1
    return bytes(out[:size])


def _decompress(chunk: bytes, comp: int, size: int, plain: bool) -> np.ndarray:
    """One strip or tile's bytes, decompressed, as `size` uint8 (short data
    padded with zeros, as libtiff pads it)."""
    if comp == 1:
        raw = np.frombuffer(chunk[:size], np.uint8)
    elif comp in (8, 32946):
        raw = np.frombuffer(zlib.decompressobj().decompress(chunk, size), np.uint8)
    elif comp == 5:
        raw = np.frombuffer(_lzw_decode_plain(chunk, size), np.uint8) if plain else native.lzw_decode(chunk, size)
    else:
        raw = (np.frombuffer(_packbits_plain(chunk, size), np.uint8) if plain
               else native.packbits_decode(chunk, size))
    if len(raw) < size:
        raw = np.concatenate([raw, np.zeros(size - len(raw), np.uint8)])
    return raw


def _samples(raw: np.ndarray, rows: int, width: int, spp: int, dtype, bo: str, predictor: int) -> np.ndarray:
    """A decompressed block of `rows` x `width` pixels -> (rows, width, spp)
    values in native byte order, the predictor undone."""
    item = np.dtype(dtype).itemsize
    if predictor == 3:  # bytes differenced along the row, then planes of the sample's bytes, most significant first
        b = np.cumsum(raw.reshape(rows, -1, spp), axis=1, dtype=np.uint8).reshape(rows, item, width * spp)
        return b.transpose(0, 2, 1).copy().view(np.dtype(dtype).newbyteorder(">")).astype(dtype).reshape(
            rows, width, spp)
    a = raw.view(np.dtype(dtype).newbyteorder(bo)).astype(dtype).reshape(rows, width, spp)
    if predictor == 2:
        np.cumsum(a, axis=1, dtype=dtype, out=a)  # a is astype's copy
    return a


def decode_tiff(data: bytes, plain: bool = False) -> np.ndarray:
    """The bytes of a TIFF file -> its first image (see the module
    docstring). `plain` takes the Python LZW and PackBits decoders."""
    bo, off = tiff_header(data)
    tags = exif._ifd(data, off, bo)
    w, h = int(tags[WIDTH]), int(tags[HEIGHT])
    spp = int(tags.get(SPP, 1))
    bits = set(_tuple(tags.get(BITS, 1)))
    fmt = set(_tuple(tags.get(SAMPLE_FORMAT, 1)))
    comp = int(tags.get(COMPRESSION, 1))
    photometric = int(tags.get(PHOTOMETRIC, 1))
    planar = int(tags.get(PLANAR, 1))
    predictor = int(tags.get(PREDICTOR, 1))
    if comp not in _TAKEN:
        raise ValueError(f"TIFF compression {comp} ({_NOT_TAKEN.get(comp, 'unknown')}) is not taken")
    key = (min(fmt), min(bits))
    if len(bits) != 1 or len(fmt) != 1 or key not in _DTYPES:
        raise ValueError(f"TIFF BitsPerSample {sorted(bits)} of SampleFormat {sorted(fmt)} is not taken "
                         "(8 and 16-bit unsigned, 32-bit float)")
    dtype = _DTYPES[key]
    if photometric not in _PHOTOMETRIC:
        raise ValueError(f"TIFF PhotometricInterpretation {photometric} is not taken")
    if not 1 <= spp <= 4 or planar not in (1, 2):
        raise ValueError(f"TIFF SamplesPerPixel {spp}, PlanarConfiguration {planar} is not taken")
    is_float = dtype == np.float32
    if predictor not in (1, 2, 3) or (predictor == 2 and is_float) or (predictor == 3 and not is_float):
        raise ValueError(f"TIFF Predictor {predictor} for {np.dtype(dtype).name} samples is not taken")
    if int(tags.get(266, 1)) != 1:
        raise ValueError("TIFF FillOrder 2 is not taken")
    planes, spp_c = (spp, 1) if planar == 2 else (1, spp)
    out = np.empty((planes, h, w, spp_c), dtype)
    item = np.dtype(dtype).itemsize
    if TILE_OFFSETS in tags:
        tw, th = int(tags[TILE_W]), int(tags[TILE_H])
        offs, counts = _tuple(tags[TILE_OFFSETS]), _tuple(tags[TILE_COUNTS])
        across, down = -(-w // tw), -(-h // th)
        if len(offs) < planes * across * down:
            raise ValueError(f"TIFF with {len(offs)} tiles, expected {planes * across * down}")
        size = th * tw * spp_c * item
        for i in range(planes * across * down):
            p, r = divmod(i, across * down)
            ty, tx = divmod(r, across)
            raw = _decompress(data[offs[i]:offs[i] + counts[i]], comp, size, plain)
            tile = _samples(raw, th, tw, spp_c, dtype, bo, predictor)
            y0, x0 = ty * th, tx * tw
            out[p, y0:y0 + th, x0:x0 + tw] = tile[:h - y0, :w - x0]
    else:
        rps = max(1, min(int(tags.get(ROWS_PER_STRIP, h)), h))
        offs, counts = _tuple(tags[STRIP_OFFSETS]), _tuple(tags.get(STRIP_COUNTS, ()))
        per_plane = -(-h // rps)
        if len(offs) < planes * per_plane:
            raise ValueError(f"TIFF with {len(offs)} strips, expected {planes * per_plane}")
        row_bytes = w * spp_c * item
        for p in range(planes):
            raw = np.empty(h * row_bytes, np.uint8)
            for s in range(per_plane):
                i = p * per_plane + s
                rows = min(rps, h - s * rps)
                n = counts[i] if i < len(counts) else rows * row_bytes
                raw[s * rps * row_bytes:(s * rps + rows) * row_bytes] = _decompress(
                    data[offs[i]:offs[i] + n], comp, rows * row_bytes, plain)
            out[p] = _samples(raw, h, w, spp_c, dtype, bo, predictor)
    img = out[..., 0].transpose(1, 2, 0) if planar == 2 else out[0]
    return img[..., 0] if spp == 1 else img


def read_tiff(path: str, plain: bool = False) -> np.ndarray:
    """`decode_tiff` of the file at `path`."""
    with open(path, "rb") as f:
        return decode_tiff(f.read(), plain)


def _entry(tag: int, typ: int, values, bo: str) -> tuple:
    fmt = {3: "H", 4: "L"}[typ]
    values = _tuple(values)
    return tag, typ, struct.pack(bo + fmt * len(values), *values)


def assemble(width: int, height: int, spp: int, bits: int, strips: list, rows_per_strip: int, order: str = "II",
             compression: int = 1, predictor: int = 1, ifd0_extra=(), exif_tags=()) -> bytes:
    """A classic TIFF of one image from its encoded strips (unsigned
    samples, PlanarConfiguration 1). The same bytes object given twice is
    stored once, and both StripOffsets entries point at it. `ifd0_extra`
    and `exif_tags` are (tag, type, packed bytes) entries for IFD0 and an
    Exif sub-IFD (`exif.camera_tags` gives Make, Model and FocalLength)."""
    bo = "<" if order == "II" else ">"
    body, where = bytearray(), {}
    for s in strips:
        if id(s) not in where:
            where[id(s)] = 8 + len(body)
            body += s + b"\0" * (len(s) % 2)
    ifd_off = 8 + len(body)
    entries = [
        _entry(WIDTH, 4, width, bo), _entry(HEIGHT, 4, height, bo), _entry(BITS, 3, (bits,) * spp, bo),
        _entry(COMPRESSION, 3, compression, bo), _entry(PHOTOMETRIC, 3, 2 if spp >= 3 else 1, bo),
        _entry(STRIP_OFFSETS, 4, tuple(where[id(s)] for s in strips), bo), _entry(SPP, 3, spp, bo),
        _entry(ROWS_PER_STRIP, 4, rows_per_strip, bo), _entry(STRIP_COUNTS, 4, tuple(len(s) for s in strips), bo),
        _entry(PLANAR, 3, 1, bo), _entry(SAMPLE_FORMAT, 3, (1,) * spp, bo), *ifd0_extra,
    ]
    if spp in (2, 4):
        entries.append(_entry(EXTRA_SAMPLES, 3, 2, bo))  # unassociated alpha
    if predictor != 1:
        entries.append(_entry(PREDICTOR, 3, predictor, bo))
    if exif_tags:
        entries.append((exif.EXIF_IFD, 4, None))
    sub_off = ifd_off + len(exif.pack_ifd(entries, ifd_off, bo))
    sub_off += sub_off % 2
    ifd0 = exif.pack_ifd(entries, ifd_off, bo, sub_off)
    out = order.encode() + struct.pack(bo + "HL", 42, ifd_off) + bytes(body) + ifd0
    if exif_tags:
        out += b"\0" * (sub_off - len(out)) + exif.pack_ifd(list(exif_tags), sub_off, bo)
    return out


def tiff_bytes(img: np.ndarray, **kw) -> bytes:
    """A uint8 or uint16 (H, W[, C]) array, C in 1..4, as a baseline
    uncompressed TIFF in one strip (`kw` goes to `assemble`)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_tiff takes uint8 or uint16 pixels, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, spp = img.shape
    if not 1 <= spp <= 4:
        raise ValueError(f"write_tiff takes 1 to 4 channels, not {spp}")
    bo = "<" if kw.get("order", "II") == "II" else ">"
    strip = np.ascontiguousarray(img, np.dtype(img.dtype).newbyteorder(bo)).tobytes()
    return assemble(w, h, spp, 8 * img.dtype.itemsize, [strip], h, **kw)


def write_tiff(path: str, img: np.ndarray) -> None:
    """Write `tiff_bytes(img)` to `path`."""
    data = tiff_bytes(img)
    with open(path, "wb") as f:
        f.write(data)
