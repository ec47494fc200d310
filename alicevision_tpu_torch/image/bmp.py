"""BMP reader and writer of the port, with no image codec library.

Counterpart of the BMP half of `alicevision_tpu/image/io.py`, which reads
and writes `.bmp` through imageio (Pillow). `decode_bmp` takes the
BITMAPINFOHEADER (and its V2, V3 extensions), V4 and V5 headers; 1-, 4-
and 8-bit palette images, raw or RLE8 / RLE4; 24-bit; and 32-bit, raw
(BGRX) or BI_BITFIELDS with the byte-aligned masks Pillow
takes; bottom-up and top-down (negative height) rows. It returns what
imageio returns:

- a palette image as its RGB colours, (H, W, 3) uint8, except where the
  palette is Pillow's grey ramp (entry i = (i, i, i), or black and white
  for two colours): then (H, W) uint8, or bool for black and white;
- 24-bit and raw 32-bit as RGB (the fourth byte dropped), (H, W, 3);
- BI_BITFIELDS with an alpha mask as RGBA, (H, W, 4).

Variants Pillow refuses raise a ValueError, and so do 16-bit images
("BMP 16-bit") and JPEG or PNG payloads, which the port does not take.
`write_bmp` writes Pillow's bytes for `imageio.imwrite`: (H, W) uint8 as
8-bit with a grey palette, bool as 1-bit, RGB as 24-bit and RGBA as 32-bit
BI_RGB, bottom-up, 96 dpi.
"""

from __future__ import annotations

import struct

import numpy as np

_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
_COMPRESSION = {4: "JPEG", 5: "PNG", 6: "alpha bitfields"}
# Pillow's 32-bit BI_BITFIELDS layouts: (r, g, b, a) masks -> the byte of
# each channel in a little-endian pixel (None for no alpha)
_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): (2, 1, 0, None),
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): (3, 2, 1, None),
    (0xFF000000, 0xFF00, 0xFF, 0x0): (3, 1, 0, None),
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1, 0),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2, 3),
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0, 3),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0, 2),
    (0x0, 0x0, 0x0, 0x0): (2, 1, 0, 3),
}
_PPM = 3780  # 96 dpi, as Pillow writes it


def _rle(data: bytes, w: int, h: int, rle4: bool) -> np.ndarray:
    """RLE8 / RLE4 -> (h, w) indices in file row order (the first row is
    the bottom one for a bottom-up file). End of line pads the row with
    index 0 and a delta skips pixels as 0, as Pillow fills them."""
    out = bytearray()
    n, pos, x = w * h, 0, 0
    while len(out) < n and pos + 1 < len(data):
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            count = min(count, max(0, w - x))
            if rle4:
                out += bytes((byte >> 4, byte & 15) * (count // 2 + 1))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:  # end of line
            out += b"\0" * (-len(out) % w)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta
            if pos + 1 >= len(data):
                break
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += b"\0" * (right + up * w)
            x = len(out) % w
        else:  # absolute run of `byte` pixels, word-aligned
            nbytes = (byte + 1) // 2 if rle4 else byte
            run = data[pos:pos + nbytes]
            pos += nbytes + (nbytes & 1)
            if rle4:
                run = bytes(v for b in run for v in (b >> 4, b & 15))[:byte]
            out += run
            x += byte
            if len(run) < byte:
                break
    out = out[:n] + b"\0" * max(0, n - len(out))
    return np.frombuffer(bytes(out), np.uint8).reshape(h, w)


def decode_bmp(data: bytes) -> np.ndarray:
    """The bytes of a BMP file -> its pixels (see the module docstring)."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    (offset,) = struct.unpack("<L", data[10:14])
    (hsize,) = struct.unpack("<L", data[14:18])
    head = data[18:14 + hsize]
    pos = 14 + hsize
    if hsize not in (40, 52, 56, 64, 108, 124):
        raise ValueError(f"BMP header of {hsize} bytes is not taken")
    w, h, _, bits, comp = struct.unpack("<lLHHL", head[:16])
    (colors,) = struct.unpack("<L", head[28:32])
    top_down = h >= 1 << 31
    h = 2**32 - h if top_down else h
    if len(data) < pos:
        raise ValueError("truncated BMP header")
    colors = colors or (1 << bits if bits <= 8 else 0)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 24, 32):
        raise ValueError(f"BMP {bits}-bit pixels are not taken")
    channels = None
    if comp == _BITFIELDS:
        if hsize >= 52:
            masks = struct.unpack("<LLL", head[36:48]) + (struct.unpack("<L", head[48:52]) if hsize >= 56 else (0,))
        else:
            masks = struct.unpack("<LLL", data[pos:pos + 12]) + (0,)
            pos += 12
        if bits == 32 and masks in _MASKS32:
            channels = _MASKS32[masks]
        elif not (bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF)):
            raise ValueError(f"BMP BI_BITFIELDS masks {tuple(hex(m) for m in masks)} at {bits} bits are not taken")
    elif comp in (_RLE8, _RLE4):
        if bits != (8 if comp == _RLE8 else 4):
            raise ValueError(f"BMP RLE{8 if comp == _RLE8 else 4} at {bits} bits is not taken")
    elif comp != _RAW:
        raise ValueError(f"BMP compression {comp} ({_COMPRESSION.get(comp, 'unknown')}) is not taken")
    order = slice(None) if top_down else slice(None, None, -1)
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP palette of {colors} colours is not taken")
        pal = np.frombuffer(data[pos:pos + 4 * colors], np.uint8).reshape(-1, 4)[:, 2::-1]  # BGRX -> RGB
        if comp in (_RLE8, _RLE4):
            idx = _rle(data[offset:], w, h, comp == _RLE4)[order]
        else:
            stride = ((w * bits + 31) >> 3) & ~3
            rows = np.frombuffer(data[offset:offset + stride * h], np.uint8)
            if len(rows) < stride * h:
                raise ValueError("truncated BMP pixel data")
            rows = rows.reshape(h, stride)[order]
            per = 8 // bits
            shifts = (8 - bits * (np.arange(per) + 1)).astype(np.uint8)
            idx = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(h, -1)[:, :w]
        ramp = (0, 255) if colors == 2 else range(colors)
        if len(pal) == colors and all((pal[i] == v).all() for i, v in enumerate(ramp)):
            return idx.astype(bool) if colors == 2 else idx
        lut = np.zeros((256, 3), np.uint8)
        lut[:min(len(pal), 256)] = pal[:256]
        return lut[idx]
    nb = bits // 8
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.frombuffer(data[offset:offset + stride * h], np.uint8)
    if len(rows) < stride * h:
        raise ValueError("truncated BMP pixel data")
    px = rows.reshape(h, stride)[order][:, :w * nb].reshape(h, w, nb)
    if channels is None:
        return np.ascontiguousarray(px[..., 2::-1])  # BGR(X) -> RGB
    return np.ascontiguousarray(px[..., [c for c in channels if c is not None]])


def read_bmp(path: str) -> np.ndarray:
    """`decode_bmp` of the file at `path`."""
    with open(path, "rb") as f:
        return decode_bmp(f.read())


def bmp_size(data: bytes) -> tuple:
    """(width, height) from a BMP's header."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    w, h = struct.unpack("<lL", data[18:26])
    return w, 2**32 - h if h >= 1 << 31 else h


def write_bmp(path: str, img: np.ndarray) -> None:
    """Write Pillow's BMP of a bool or uint8 (H, W), or uint8 (H, W, 3|4)."""
    img = np.asarray(img)
    if img.dtype == bool and img.ndim == 2:
        bits, palette = 1, b"\0\0\0\0\xff\xff\xff\0"
        packed = np.packbits(img, axis=1)
    elif img.dtype == np.uint8 and img.ndim == 2:
        bits, palette = 8, np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
        palette[:, 3] = 0
        palette, packed = palette.tobytes(), img
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] in (3, 4):
        bits, palette = 8 * img.shape[2], b""
        packed = img[..., [2, 1, 0, 3][:img.shape[2]]].reshape(img.shape[0], -1)
    else:
        raise ValueError(f"BMP takes bool or uint8 (H, W) or uint8 (H, W, 3|4), not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    stride = ((w * bits + 7) // 8 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :packed.shape[1]] = packed
    colors = len(palette) // 4
    offset = 14 + 40 + len(palette)
    head = b"BM" + struct.pack("<LLL", offset + stride * h, 0, offset)
    info = struct.pack("<LllHHLLllLL", 40, w, h, 1, bits, 0, stride * h, _PPM, _PPM, colors, colors)
    with open(path, "wb") as f:
        f.write(head + info + palette + rows[::-1].tobytes())
