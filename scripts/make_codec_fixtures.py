#!/usr/bin/env python3
"""Write the port's TIFF, BMP, PNG and AVI fixtures and the JAX package's
reading of them.

    python3 scripts/make_codec_fixtures.py

Writes small files under `alicevision_tpu_torch/data/codec_fixtures/`:
every TIFF, BMP and PNG variant the port's readers take (each compression,
predictor, tile and plane layout, byte order, bit depth, colour type,
palette, tRNS, Adam7, RLE, top-down rows and header version), a few that
they refuse, one cv2 MJPEG AVI, and `lzw_strip.tif` (one 6000x4 16-bit
RGB strip, LZW with predictor 2, that chip_smoke.py's `codecs` phase
points every strip of a 24 MP TIFF at). Pillow, cv2 (libtiff, libpng,
FFmpeg) and imageio's bundled tifffile write what they can; this script's
own encoders (test code: LZW, PackBits, the predictors, raw PNG rows with
every filter, Adam7, RLE) write the rest.

Beside them `fixtures.json` records, for each file, what the JAX package
reads (`alicevision_tpu.image.io.read_image`'s source pixels through
imageio, and `read_exif`): dtype, shape and SHA-256 of the pixels, or
"raises". Where the port parts from it by design (16-bit PNG with colour
or alpha, PlanarConfiguration 2, the Exif sub-IFD focal, variants the port
refuses), a "port" entry holds the port's expected reading from an
independent source (cv2's 16-bit read, the transposed planes, the tag
written) and a "why". For the AVI it records cv2's frame count and the
SHA-256 of PIL's decode of each frame chunk. The card's machine has no
PIL, imageio or cv2: chip_smoke.py holds the port to this file there.
Needs imageio, PIL and cv2; the images are seeded numpy, so a rerun
writes the same pixels (the tifffile files' DateTime tag, and cv2's AVI
across versions, change bytes, not pixels).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys
import tempfile
import warnings
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from alicevision_tpu_torch.image import exif, jpeg  # noqa: E402

OUT = os.path.join(ROOT, "alicevision_tpu_torch", "data", "codec_fixtures")
CAMERA = ("Canon", "Canon EOS 5D Mark III", 31.5)
STRIP_WH = (6000, 4)


def smooth(h: int, w: int, ch: int, seed: int, top: int = 255) -> np.ndarray:
    """Seeded colour waves with noise, values in [0, top]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([0.5 + 0.4 * np.sin(x / 3 + c) * np.cos(y / 2 - c) for c in range(ch)], -1)
    img = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1)
    return np.round(img * top).astype(np.uint16 if top > 255 else np.uint8)


# ------------------------------------------------------------------ PNG


def _pack_rows(px: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, ch) samples -> (h, stride) bytes, MSB first / big-endian."""
    h = px.shape[0]
    flat = px.reshape(h, -1).astype(np.uint16)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    pad = -flat.shape[1] % per
    flat = np.concatenate([flat, np.zeros((h, pad), np.uint16)], 1).reshape(h, -1, per)
    shifts = 8 - depth * (np.arange(per) + 1)
    return (flat << shifts).sum(-1).astype(np.uint8)


def _filter_rows(rows: np.ndarray, bpp: int) -> bytes:
    """Filter row y with type y % 5, so every filter is exercised."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for y, r in enumerate(rows.astype(np.int32)):
        kind = y % 5
        a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 0:
            f = r
        elif kind == 1:
            f = r - a
        elif kind == 2:
            f = r - prev
        elif kind == 3:
            f = r - ((a + prev) >> 1)
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            f = r - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(bytes([kind]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def raw_png(px: np.ndarray, depth: int, color: int, palette=None, trns=None, interlace=False) -> bytes:
    """A PNG of the samples `px` (h, w, ch), every row filter used."""
    from alicevision_tpu_torch.image.png import ADAM7, PNG_SIG, _chunk

    h, w, ch = px.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        data = b""
        for x0, y0, dx, dy in ADAM7:
            sub = px[y0::dy, x0::dx]
            if sub.size:
                data += _filter_rows(_pack_rows(sub, depth), bpp)
    else:
        data = _filter_rows(_pack_rows(px, depth), bpp)
    out = PNG_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(data, 9)) + _chunk(b"IEND", b"")


def png_fixtures() -> dict:
    g = lambda d: (smooth(11, 13, 1, d, (1 << d) - 1) if d < 16 else smooth(11, 13, 1, d, 65535))  # noqa: E731
    rng = np.random.default_rng(3)
    pal = rng.integers(0, 256, (16, 3))
    idx = lambda d: (smooth(11, 13, 1, 7, 255) % min(16, 1 << d)).astype(np.uint8)  # noqa: E731
    rgb8, rgb16 = smooth(11, 13, 3, 1), smooth(11, 13, 3, 2, 65535)
    la8, la16 = smooth(11, 13, 2, 4), smooth(11, 13, 2, 5, 65535)
    rgba8, rgba16 = smooth(11, 13, 4, 6), smooth(11, 13, 4, 8, 65535)
    out = {f"png_g{d}.png": raw_png(g(d), d, 0) for d in (1, 2, 4, 8, 16)}
    out.update({
        "png_rgb8.png": raw_png(rgb8, 8, 2), "png_rgb16.png": raw_png(rgb16, 16, 2),
        "png_la8.png": raw_png(la8, 8, 4), "png_la16.png": raw_png(la16, 16, 4),
        "png_rgba8.png": raw_png(rgba8, 8, 6), "png_rgba16.png": raw_png(rgba16, 16, 6),
        "png_g8_trns.png": raw_png(g(8), 8, 0, trns=b"\0\x11"),
        "png_rgb8_trns.png": raw_png(rgb8, 8, 2, trns=b"\0\1\0\2\0\3"),
        "png_p8_trns.png": raw_png(idx(8), 8, 3, pal, trns=bytes(range(0, 256, 32))),
        "png_adam7_g1.png": raw_png(g(1), 1, 0, interlace=True),
        "png_adam7_rgb8.png": raw_png(rgb8, 8, 2, interlace=True),
        "png_adam7_p4.png": raw_png(idx(4), 4, 3, pal, interlace=True),
        "png_adam7_rgba16.png": raw_png(rgba16, 16, 6, interlace=True),
        "png_adam7_tiny.png": raw_png(rgb8[:2, :3], 8, 2, interlace=True),
    })
    for d in (1, 2, 4, 8):
        out[f"png_p{d}.png"] = raw_png(idx(d), d, 3, pal[:1 << d])
    from PIL import Image
    import cv2

    b = io.BytesIO()
    Image.fromarray(smooth(17, 23, 3, 9)).save(b, format="PNG")
    out["png_pil_rgb.png"] = b.getvalue()
    ok, buf = cv2.imencode(".png", smooth(17, 23, 3, 10, 65535)[..., ::-1])
    out["png_cv2_rgb16.png"] = buf.tobytes()
    return out


# ----------------------------------------------------------------- TIFF


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (the decoder's early width change: 10 bits from code 511)."""
    bits, nbits = [], 0
    width, table, nxt = 9, {bytes([i]): i for i in range(256)}, 258

    def emit(code):
        bits.append((code, width))

    emit(256)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt >= 4094:
            emit(256)
            width, table, nxt = 9, {bytes([i]): i for i in range(256)}, 258
        elif nxt >= (1 << width) and width < 12:
            width += 1
        w = bytes([c])
    if w:
        emit(table[w])
        nxt += 1
        if nxt >= (1 << width) and width < 12:
            width += 1
    emit(257)
    acc = 0
    for code, wd in bits:
        acc = (acc << wd) | code
        nbits += wd
    pad = -nbits % 8
    return (acc << pad).to_bytes((nbits + pad) // 8, "big")


def packbits_encode(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1)]) + data[i:i + 1]
            i = j + 1
            continue
        j = i + 1
        while j < len(data) and j - i < 128 and not (j + 1 < len(data) and data[j + 1] == data[j]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _predict(block: np.ndarray, predictor: int, bo: str) -> bytes:
    """(rows, width, spp) samples -> the block's bytes with the predictor."""
    rows, width, spp = block.shape
    if predictor == 3:
        be = block.astype(">f4").view(np.uint8).reshape(rows, width * spp, 4)
        planes = be.transpose(0, 2, 1).reshape(rows, -1).astype(np.int32)
        d = planes.reshape(rows, -1, spp)
        d = np.concatenate([d[:, :1], d[:, 1:] - d[:, :-1]], 1)
        return (d & 0xFF).astype(np.uint8).tobytes()
    if predictor == 2:
        block = np.concatenate([block[:, :1], block[:, 1:] - block[:, :-1]], 1).astype(block.dtype)
    return block.astype(block.dtype.newbyteorder(bo)).tobytes()


def tiff_file(img: np.ndarray, order="II", compression=1, predictor=1, tile=None, planar=1, rows=None,
              photometric=None, colormap=None, extra=(), sub=(), bigtiff=False) -> bytes:
    """A TIFF of `img` (H, W[, S]) with this script's encoders."""
    bo = "<" if order == "II" else ">"
    img = img[..., None] if img.ndim == 2 else img
    h, w, spp = img.shape
    bits = 8 * img.dtype.itemsize
    fmt = 3 if img.dtype == np.float32 else 1
    enc = {5: lzw_encode, 8: lambda b: zlib.compress(b, 9), 32946: lambda b: zlib.compress(b, 9),
           32773: packbits_encode}.get(compression, lambda b: b)  # others: the bytes as they are
    planes = [img[..., i:i + 1] for i in range(spp)] if planar == 2 else [img]
    chunks = []
    for p in planes:
        if tile:
            th, tw = tile
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    t = np.zeros((th, tw, p.shape[2]), img.dtype)
                    part = p[y:y + th, x:x + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(enc(_predict(t, predictor, bo)))
        else:
            r = rows or h
            chunks += [enc(_predict(p[y:y + r], predictor, bo)) for y in range(0, h, r)]
    body, offs = b"", []
    for c in chunks:
        offs.append(8 + len(body))
        body += c + b"\0" * (len(c) & 1)

    def S(tag, v):  # SHORTs
        return tag, 3, struct.pack(bo + "%dH" % len(v), *v)

    def L(tag, v):  # LONGs
        return tag, 4, struct.pack(bo + "%dL" % len(v), *v)

    if photometric is None:
        photometric = 2 if spp >= 3 else 1
    entries = [L(256, [w]), L(257, [h]), S(258, [bits] * spp), S(259, [compression]), S(262, [photometric]),
               S(277, [spp]), S(284, [planar]), S(339, [fmt] * spp), *extra]
    if tile:
        entries += [S(322, [tile[1]]), S(323, [tile[0]]), L(324, offs), L(325, [len(c) for c in chunks])]
    else:
        entries += [L(273, offs), L(278, [rows or h]), L(279, [len(c) for c in chunks])]
    if predictor != 1:
        entries.append(S(317, [predictor]))
    if spp in (2, 4):
        entries.append(S(338, [2]))
    if colormap is not None:
        entries.append(S(320, list(colormap.ravel())))
    if sub:
        entries.append((exif.EXIF_IFD, 4, None))
    ifd_off = 8 + len(body)
    sub_off = ifd_off + len(exif.pack_ifd(entries, ifd_off, bo))
    sub_off += sub_off & 1
    out = order.encode() + struct.pack(bo + "HL", 42, ifd_off) + body + exif.pack_ifd(entries, ifd_off, bo, sub_off)
    if sub:
        out += b"\0" * (sub_off - len(out)) + exif.pack_ifd(list(sub), sub_off, bo)
    if bigtiff:
        out = out[:2] + struct.pack(bo + "H", 43) + out[4:]  # the header alone: the reader refuses it there
    return out


def _written(fn, suffix: str) -> bytes:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "f" + suffix)
        fn(path)
        with open(path, "rb") as f:
            return f.read()


def tiff_fixtures() -> dict:
    from PIL import Image
    import cv2
    from imageio.plugins import _tifffile as tf

    rgb8, rgb16 = smooth(21, 37, 3, 11), smooth(21, 37, 3, 12, 65535)
    g8, g16 = smooth(21, 37, 1, 13)[..., 0], smooth(21, 37, 1, 14, 65535)[..., 0]
    fl = (smooth(21, 37, 1, 15, 65535)[..., 0] / 6553.5 - 3.0).astype(np.float32)
    out = {}
    for comp, name in ((None, "none"), ("tiff_lzw", "lzw"), ("tiff_adobe_deflate", "deflate"),
                       ("packbits", "packbits")):
        out[f"tif_pil_rgb_{name}.tif"] = _written(lambda p, c=comp: Image.fromarray(rgb8).save(p, compression=c),
                                                  ".tif")
    out["tif_pil_rgba.tif"] = _written(lambda p: Image.fromarray(smooth(21, 37, 4, 16)).save(p), ".tif")
    out["tif_pil_la.tif"] = _written(lambda p: Image.fromarray(smooth(21, 37, 2, 17), "LA").save(p), ".tif")
    out["tif_pil_g8_lzw.tif"] = _written(lambda p: Image.fromarray(g8).save(p, compression="tiff_lzw"), ".tif")
    out["tif_cv2_rgb16_lzw_pred2.tif"] = _written(lambda p: cv2.imwrite(p, rgb16[..., ::-1]), ".tif")

    def tifffile(**kw):
        def save(p, data=kw.pop("data"), order=kw.pop("byteorder", "<")):
            with tf.TiffWriter(p, byteorder=order) as t:
                t.save(data, **kw)
        return _written(save, ".tif")

    out["tif_tifffile_mm_g16.tif"] = tifffile(data=g16, byteorder=">")
    out["tif_tifffile_tiles_rgb16_deflate_pred2.tif"] = tifffile(data=rgb16, tile=(16, 16), compress=6, predictor=True)
    out["tif_tifffile_float_deflate.tif"] = tifffile(data=fl, compress=6)
    out["tif_tifffile_planar_rgb16.tif"] = tifffile(data=np.ascontiguousarray(rgb16.transpose(2, 0, 1)),
                                                    planarconfig="SEPARATE", photometric="RGB", byteorder=">")
    cmap = np.random.default_rng(18).integers(0, 65536, (3, 256))
    out["tif_palette8.tif"] = tiff_file(g8 % 16, photometric=3, colormap=cmap)
    out["tif_miniswhite8.tif"] = tiff_file(g8, photometric=0, compression=32773)
    out.update({
        "tif_mm_rgb16_lzw_pred2.tif": tiff_file(rgb16, "MM", 5, 2, rows=5),
        "tif_ii_g8_deflate_pred2.tif": tiff_file(g8, "II", 32946, 2, rows=8),
        "tif_mm_g16_packbits.tif": tiff_file(g16, "MM", 32773, rows=6),
        "tif_tiles_rgb8_lzw.tif": tiff_file(rgb8, compression=5, tile=(16, 16)),
        "tif_planar_tiles_rgb8_lzw_pred2.tif": tiff_file(rgb8, "MM", 5, 2, tile=(16, 16), planar=2),
        "tif_float_pred3_deflate.tif": tiff_file(fl, "II", 8, 3, rows=7),
        "tif_float_mm_pred3_lzw.tif": tiff_file(fl, "MM", 5, 3, rows=4),
        "tif_rgba16_lzw.tif": tiff_file(smooth(21, 37, 4, 19, 65535), compression=5, rows=10),
        "tif_bigtiff.tif": tiff_file(g8, bigtiff=True),
        "tif_jpeg.tif": tiff_file(g8, compression=7),
    })
    for order in ("II", "MM"):
        bo = "<" if order == "II" else ">"
        for where in ("ifd0", "exif"):
            ifd0, sub = exif.camera_tags(*CAMERA, bo, where)
            out[f"tif_exif_{where}_{order.lower()}.tif"] = tiff_file(smooth(9, 12, 3, 20), order, extra=ifd0, sub=sub)
    return out


def lzw_strip() -> bytes:
    """One 6000x4 16-bit RGB strip, LZW with predictor 2, by libtiff (cv2)."""
    import cv2

    w, h = STRIP_WH
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([30000 + 20000 * np.sin(x / 400 + c) * np.cos(y / 3 - c) for c in range(3)], -1)
    img = np.round(img).astype(np.uint16)
    return _written(lambda p: cv2.imwrite(p, img[..., ::-1], [cv2.IMWRITE_TIFF_ROWSPERSTRIP, h]), ".tif")


# ------------------------------------------------------------------ BMP


def bmp_file(idx_or_px: np.ndarray, bits: int, palette=None, comp=0, top_down=False, hsize=40, masks=None,
             rle: bytes | None = None) -> bytes:
    """A BMP with this script's encoder: palette indices or BGR(A) bytes."""
    h, w = idx_or_px.shape[:2]
    if rle is not None:
        pixels = rle
    else:
        rows = idx_or_px[::1 if top_down else -1]
        if bits < 8:
            per = 8 // bits
            flat = np.concatenate([rows, np.zeros((h, -w % per), np.uint8)], 1).reshape(h, -1, per).astype(np.int32)
            rows = (flat << (8 - bits * (np.arange(per) + 1))).sum(-1).astype(np.uint8)
        else:
            rows = rows.reshape(h, -1)
        stride = ((w * bits + 31) >> 3) & ~3
        buf = np.zeros((h, stride), np.uint8)
        buf[:, :rows.shape[1]] = rows
        pixels = buf.tobytes()
    pal = b"" if palette is None else b"".join(bytes([b, g, r, 0]) for r, g, b in palette)
    colors = 0 if palette is None else len(palette)
    extra = b""
    if hsize == 40 and masks is not None:
        extra = struct.pack("<3L", *masks[:3])
    offset = 14 + hsize + len(extra) + len(pal)
    info = struct.pack("<LlLHHLLllLL", hsize, w, 2**32 - h if top_down else h, 1, bits, comp, len(pixels), 2835, 2835,
                       colors, 0)
    if hsize > 40:
        info += struct.pack("<4L", *(masks or (0, 0, 0, 0))) + b"\0" * (hsize - 56)
    return b"BM" + struct.pack("<LLL", offset + len(pixels), 0, offset) + info + extra + pal + pixels


def rle_encode(idx: np.ndarray, rle4: bool) -> bytes:
    """RLE8 / RLE4, bottom-up: runs of equal pixels, absolute runs of even
    length for the rest, an end of line each row, an end of bitmap."""
    out = bytearray()
    for row in idx[::-1]:
        x, w = 0, len(row)
        while x < w:
            n = 1
            while x + n < w and n < 255 and row[x + n] == row[x]:
                n += 1
            if n >= 3 or w - x < 4:
                v = int(row[x])
                out += bytes([n, (v << 4 | v) if rle4 else v])
                x += n
                continue
            n = 4
            while x + n + 2 <= w and n < 250 and not (row[x + n] == row[x + n + 1]):
                n += 2
            run = row[x:x + n]
            data = bytes((int(a) << 4 | int(b)) for a, b in zip(run[::2], run[1::2])) if rle4 else bytes(run)
            out += bytes([0, n]) + data + b"\0" * (len(data) & 1)
            x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmp_fixtures() -> dict:
    from PIL import Image

    rgb = smooth(13, 19, 3, 21)
    rgba = smooth(13, 19, 4, 22)
    rng = np.random.default_rng(23)
    pal16 = rng.integers(0, 256, (16, 3))
    idx16 = (smooth(13, 19, 1, 24)[..., 0] // 64).astype(np.uint8) * 5 % 16
    idx256 = smooth(13, 19, 1, 25)[..., 0]
    pal256 = rng.integers(0, 256, (256, 3))
    out = {}
    for mode in ("1", "L", "RGB", "RGBA"):
        im = Image.fromarray(rgba if mode == "RGBA" else rgb)
        out[f"bmp_pil_{mode.lower()}.bmp"] = _written(lambda p, m=mode, i=im: i.convert(m).save(p), ".bmp")
    out["bmp_pil_p.bmp"] = _written(
        lambda p: Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=16).save(p), ".bmp")
    out.update({
        "bmp_4bit.bmp": bmp_file(idx16, 4, pal16),
        "bmp_1bit_colour.bmp": bmp_file(idx16 & 1, 1, pal16[:2]),
        "bmp_8bit_topdown.bmp": bmp_file(idx256, 8, pal256, top_down=True),
        "bmp_rle8.bmp": bmp_file(idx256 // 16 * 16, 8, pal256, comp=1, rle=rle_encode(idx256 // 16 * 16, False)),
        "bmp_rle4.bmp": bmp_file(idx16, 4, pal16, comp=2, rle=rle_encode(idx16, True)),
        "bmp_24_topdown.bmp": bmp_file(rgb[..., ::-1], 24, top_down=True),
        "bmp_v4_bitfields_rgba.bmp": bmp_file(rgba[..., [2, 1, 0, 3]], 32, comp=3, hsize=108,
                                              masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        "bmp_v5_bitfields_xbgr.bmp": bmp_file(np.dstack([np.zeros_like(rgb[..., :1]), rgb[..., ::-1]]), 32, comp=3,
                                              hsize=124, masks=(0xFF000000, 0xFF0000, 0xFF00, 0)),
        "bmp_40_bitfields_bgrx.bmp": bmp_file(np.dstack([rgb[..., ::-1], rgb[..., :1]]), 32, comp=3,
                                              masks=(0xFF0000, 0xFF00, 0xFF)),
        "bmp_16bit.bmp": bmp_file(np.zeros((13, 19, 2), np.uint8), 16),
    })
    return out


# ------------------------------------------------------------------ AVI


def avi_fixtures() -> dict:
    import cv2

    sys.path.insert(0, ROOT)
    import chip_smoke

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "clip.avi")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48), isColor=True)
        for i in range(5):
            vw.write(np.roll(smooth(48, 64, 3, 26), 3 * i, axis=1))
        vw.release()
        with open(path, "rb") as f:
            clip = f.read()
    frames = [jpeg.encode(np.roll(smooth(48, 64, 3, 27), 5 * i, axis=1), 85) for i in range(4)]
    return {
        "avi_cv2_mjpeg.avi": clip,
        "avi_dropped_frame.avi": chip_smoke.mjpeg_avi(frames[:2] + [b""] + frames[2:], 64, 48),
        "avi_h264.avi": chip_smoke.mjpeg_avi(frames[:1], 64, 48, codec=b"H264"),
    }


# --------------------------------------------------------------- oracle


def _digest(a: np.ndarray) -> dict:
    """dtype, shape and SHA-256 of an array (a bool array's bytes made 0 or
    1: Pillow's hold 255 for True)."""
    a = np.ascontiguousarray(a != 0 if a.dtype == bool else a)
    return {"dtype": a.dtype.name, "shape": list(a.shape), "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def _jax_exif(path: str) -> dict:
    from alicevision_tpu.image.io import read_exif

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return read_exif(path)
    except Exception as e:  # noqa: BLE001
        return {"raises": f"{type(e).__name__}: {str(e)[:80]}"}


def oracle(name: str, path: str, data: bytes) -> dict:
    """What the JAX package reads of one fixture, and the port's expected
    reading where it parts."""
    import imageio.v2 as imageio

    row = {}
    if name.endswith(".avi"):
        import cv2
        from PIL import Image

        cap = cv2.VideoCapture(path)
        n = 0
        while cap.read()[0]:
            n += 1
        cap.release()
        row["cv2_frames"] = n
        if name == "avi_h264.avi":
            row["port"] = {"raises": "AVI codec H264"}
            return row
        from alicevision_tpu_torch.image import avi

        info = avi.parse(data)
        row["frames"] = [_digest(np.asarray(Image.open(io.BytesIO(data[o:o + s])).convert("RGB")))
                         for o, s in info["frames"]]
        return row
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            row["jax"] = _digest(imageio.imread(path))
    except Exception as e:  # noqa: BLE001
        row["jax"] = {"raises": f"{type(e).__name__}: {str(e)[:80]}"}
    row["jax"]["exif"] = _jax_exif(path)
    port = {}
    if name in ("png_rgb16.png", "png_rgba16.png", "png_adam7_rgba16.png", "png_cv2_rgb16.png"):
        import cv2

        a = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if a.ndim == 3 and a.shape[2] == 3:
            a = a[..., ::-1]
        elif a.ndim == 3 and a.shape[2] == 4:
            a = a[..., [2, 1, 0, 3]]
        port = {**_digest(a), "why": "16 bits kept, as OIIO reads them; Pillow keeps the high byte (cv2's reading)"}
    elif "planar" in name:
        port = {**_digest(np.moveaxis(imageio.imread(path), 0, -1)),
                "why": "(H, W, S) as OIIO reads it; imageio returns (S, H, W) (the transposed planes)"}
    elif name in ("tif_bigtiff.tif",):
        port = {"raises": "BigTIFF"}
    elif name == "tif_jpeg.tif":
        port = {"raises": "TIFF compression 7 (JPEG)"}
    elif name == "bmp_16bit.bmp":
        port = {"raises": "BMP 16-bit"}
    if name.startswith("tif_exif_exif"):
        port["exif"] = {**row["jax"]["exif"], "make": CAMERA[0], "model": CAMERA[1], "focal_mm": CAMERA[2]}
        port["exif_why"] = "FocalLength in the Exif sub-IFD: read by the port as by OIIO; PIL's getexif holds IFD0"
    if port:
        row["port"] = port
    return row


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    files = {**png_fixtures(), **tiff_fixtures(), **bmp_fixtures(), **avi_fixtures(), "lzw_strip.tif": lzw_strip()}
    table = {}
    for name, data in sorted(files.items()):
        path = os.path.join(OUT, name)
        with open(path, "wb") as f:
            f.write(data)
        table[name] = oracle(name, path, data)
    with open(os.path.join(OUT, "fixtures.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    total = sum(len(d) for d in files.values())
    print(f"{len(files)} fixtures, {total} bytes, in {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
