"""PNG reader and writer of the port, with no image codec library.

Counterpart of the PNG half of `alicevision_tpu/image/io.py`, which reads
and writes PNG through imageio (Pillow). `read_png` takes every PNG of the
standard: bit depths 1, 2, 4, 8 and 16, colour types 0 (grey), 2 (RGB), 3
(palette), 4 (grey + alpha) and 6 (RGBA), `PLTE` and `tRNS`, and Adam7
interlacing. It returns what imageio returns:

- 1-bit grey as bool, 2- and 4-bit grey scaled to uint8 (x 85, x 17),
  8-bit as uint8 and 16-bit grey as uint16, (H, W);
- a palette image as its RGB colours, (H, W, 3) uint8;
- `tRNS` ignored (imageio drops it: grey stays grey, RGB stays RGB and a
  palette image comes out RGB);
- grey + alpha (H, W, 2), RGB (H, W, 3), RGBA (H, W, 4); 16-bit grey +
  alpha as Pillow reads it, (H, W, 4) uint8 RGBA of the high bytes.

One deliberate parting: 16-bit RGB and RGBA keep their 16 bits (uint16),
as the reference's OIIO reads them; Pillow, and so the JAX package, keeps
only the high byte of each sample (ROADMAP §3).

The row filters run in `native/codecs.cpp` (`native.png_unfilter`);
`_unfilter` is their plain numpy version (`decode_png(..., plain=True)`).
zlib is the standard library's. `write_png` writes uint8 or uint16 grey,
grey + alpha, RGB or RGBA, non-interlaced, filter 0 on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .. import native

PNG_SIG = b"\x89PNG\r\n\x1a\n"
# colour type by channel count, and back (grey, grey + alpha, RGB, RGBA)
_COLOR = {1: 0, 2: 4, 3: 2, 4: 6}
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 or uint16 (H, W[, C]) array, C in 1..4, as a
    non-interlaced PNG of depth 8 or 16 (filter 0 on every row)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG takes uint8 or uint16 pixels, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if ch not in _COLOR:
        raise ValueError(f"PNG takes 1 to 4 channels, not {ch}")
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img, ">u2" if depth == 16 else np.uint8).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (None, Sub, Up, Average, Paeth): the
    plain version of `native.png_unfilter`. Sub and Up are whole-row sums;
    Average and Paeth step along the row a pixel (bpp bytes) at a time."""
    rows = np.asarray(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride // bpp, bpp), np.int32)
    prev = np.zeros((stride // bpp, bpp), np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32).reshape(-1, bpp)
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line, axis=0) & 0xFF
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):
            cur = np.zeros_like(line)
            a = c = np.zeros(bpp, np.int32)
            for x in range(len(line)):
                b = prev[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                cur[x] = (line[x] + pred) & 0xFF
                a, c = cur[x], b
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out.reshape(h, stride).astype(np.uint8)


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """(h, stride) unfiltered bytes -> (h, w, ch) sample values (uint8, or
    uint16 at depth 16)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return rows.reshape(h, w, ch)
    per = 8 // depth  # samples a byte, most significant first
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w * ch].reshape(h, w, ch)


def _pass(raw: np.ndarray, pos: int, w: int, h: int, ch: int, depth: int, plain: bool) -> tuple:
    """One image (or Adam7 pass) of w x h from raw[pos:]: (samples, the
    position after it)."""
    if w == 0 or h == 0:
        return np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8), pos
    stride = -(-w * ch * depth // 8)
    n = h * (stride + 1)
    if pos + n > len(raw):
        raise ValueError("truncated PNG image data")
    bpp = max(1, ch * depth // 8)
    unfilter = _unfilter if plain else native.png_unfilter
    rows = unfilter(raw[pos:pos + n], h, stride, bpp)
    return _samples(rows, w, ch, depth), pos + n


def decode_png(data: bytes, plain: bool = False) -> np.ndarray:
    """The bytes of a PNG file -> its pixels as imageio gives them, but 16
    bits kept for 16-bit RGB and RGBA (see the module docstring). `plain`
    takes the numpy unfilter instead of the C++."""
    if data[:8] != PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr, palette = 8, [], None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color, comp, filt, interlace = hdr
    if color not in _DEPTHS or depth not in _DEPTHS[color]:
        raise ValueError(f"PNG bit depth {depth} with colour type {color} is not a PNG variant")
    if comp or filt or interlace > 1:
        raise ValueError(f"PNG compression {comp}, filter method {filt}, interlace {interlace} is not taken")
    if color == 3 and palette is None:
        raise ValueError("PNG palette image without a PLTE chunk")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompressobj().decompress(b"".join(idat)), np.uint8)
    if not interlace:
        px, _ = _pass(raw, 0, w, h, ch, depth, plain)
    else:
        px = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
            sub, pos = _pass(raw, pos, pw, ph, ch, depth, plain)
            px[y0::dy, x0::dx] = sub
    if color == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    if color == 0:
        g = px[..., 0]
        if depth == 1:
            return g.astype(bool)
        if depth in (2, 4):
            return (g * (255 // ((1 << depth) - 1))).astype(np.uint8)
        return g
    if color == 4 and depth == 16:
        return (px >> 8).astype(np.uint8)[..., [0, 0, 0, 1]]
    return px


def read_png(path: str, plain: bool = False) -> np.ndarray:
    """`decode_png` of the file at `path`."""
    with open(path, "rb") as f:
        return decode_png(f.read(), plain)


def png_size(data: bytes) -> tuple:
    """(width, height) from a PNG's IHDR."""
    if data[:8] != PNG_SIG or data[12:16] != b"IHDR":
        raise ValueError("not a PNG file")
    return struct.unpack(">II", data[16:24])
