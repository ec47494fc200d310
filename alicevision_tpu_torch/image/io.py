"""Host-side image IO and EXIF metadata (a numpy copy of
`alicevision_tpu/image/io.py`).

The formats the port reads and writes with its own code, with no image
codec library (the card's machine has none):

- `.npy`, with numpy alone;
- EXR, through the port's scanline reader and writer (`image/exr.py`);
- 8-bit PNG, through the standard library's zlib (`write_png`,
  `read_png`; `read_exif` reads its IHDR for the dimensions);
- JPEG (`.jpg`, `.jpeg`), through the port's codec (`image/jpeg.py` over
  `native/jpeg.cpp`: decoded byte-equal to libjpeg-turbo, which the JAX
  package reaches through imageio; written as PIL writes it at quality 75,
  4:2:0) and its EXIF reader (`image/exif.py`). A JPEG never goes to
  imageio or PIL: when the codec cannot be built, it raises.

TIFF (`.tif`, `.tiff`), BMP, PNG variants the reader does not take and
every other format still go to `imageio` (and EXIF to PIL), imported
lazily, as the reference does.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_GRAY = np.array([0.299, 0.587, 0.114], np.float32)  # Rec.601 (OIIO)
_JPEG_EXTS = (".jpg", ".jpeg")


def _is_jpeg(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in _JPEG_EXTS


def _read_exr_any(path: str):
    """EXR through the native reader; an exotic compression (PIZ etc.)
    through cv2's codec where cv2 is installed, else the reader's error."""
    from .exr import read_exr

    try:
        return read_exr(path)
    except ValueError as err:
        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
        try:
            import cv2
        except ImportError:
            raise err from None
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is not None and img.ndim == 3:
            img = img[..., ::-1]  # BGR -> RGB
        return img


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# colour type by channel count, and back (gray, gray+alpha, RGB, RGBA)
_PNG_COLOR = {1: 0, 2: 4, 3: 2, 4: 6}
_PNG_CHANNELS = {v: k for k, v in _PNG_COLOR.items()}


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 (H, W[, C]) array, C in 1..4, as an 8-bit
    non-interlaced PNG (filter 0 on every row)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG takes uint8 pixels, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if ch not in _PNG_COLOR:
        raise ValueError(f"PNG takes 1 to 4 channels, not {ch}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), np.ascontiguousarray(img).reshape(h, -1)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _png_chunk(b"IEND", b""))


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (None, Sub, Up, Average, Paeth). Sub
    and Up are whole-row sums; Average and Paeth step along the row a
    pixel (bpp bytes) at a time."""
    rows = data.reshape(h, stride + 1)
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


def read_png(path: str) -> np.ndarray:
    """Read a non-interlaced 8-bit gray, gray+alpha, RGB or RGBA PNG ->
    uint8 (H, W) or (H, W, C). Other variants (palette, interlace, other
    bit depths) raise ValueError."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIG:
        raise ValueError(f"not a PNG file: {path}")
    pos, idat, hdr = 8, [], None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos : pos + 4])
        kind, data = blob[pos + 4 : pos + 8], blob[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(f"unsupported PNG variant (depth {depth}, colour type {color}, interlace {interlace})")
    ch = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def read_image(path: str, grayscale: bool = False) -> np.ndarray:
    """Read an image -> float32 in [0, 1], (H, W[, 3])."""
    img = None
    if path.lower().endswith(".png"):
        try:
            img = read_png(path)
        except ValueError:
            pass  # a variant the reader does not take: imageio below
    if img is not None:
        pass
    elif _is_jpeg(path):
        from .jpeg import read_jpeg

        img = read_jpeg(path)
    elif path.endswith(".npy"):
        img = np.load(path)
    elif path.endswith(".exr") and os.path.exists(path + ".npy"):
        img = np.load(path + ".npy")  # legacy no-EXR-codec fallback files
    elif path.endswith(".exr"):
        img = _read_exr_any(path)
    else:
        import imageio.v2 as imageio

        img = imageio.imread(path)
    if img is None:
        raise IOError(f"cannot read image: {path}")
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    elif img.dtype == np.uint16:
        img = img.astype(np.float32) / 65535.0
    else:
        img = img.astype(np.float32)
    if grayscale and img.ndim == 3:
        img = img[..., :3] @ _GRAY
    return img


def write_image(path: str, img: np.ndarray) -> None:
    img = np.asarray(img)
    if path.endswith(".npy"):
        np.save(path, img.astype(np.float32))
        return
    if path.endswith(".exr"):
        from .exr import write_exr

        write_exr(path, img.astype(np.float32))
        return
    if img.dtype in (np.float32, np.float64):
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    if path.lower().endswith(".png") and img.dtype == np.uint8:
        write_png(path, img)
        return
    if _is_jpeg(path):
        from .jpeg import write_jpeg

        write_jpeg(path, img)
        return
    import imageio.v2 as imageio

    imageio.imwrite(path, img)


def _png_size(path: str):
    """(width, height) from a PNG's IHDR."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _PNG_SIG or head[12:16] != b"IHDR":
        raise ValueError(f"not a PNG file: {path}")
    return struct.unpack(">II", head[16:24])


def read_exif(path: str) -> dict:
    """Best-effort EXIF: make, model, focal length (mm), dimensions. A JPEG
    goes to the port's reader (`image/exif.py`): its dimensions from the
    SOF, the fields from IFD0 or the Exif sub-IFD, the dimensions alone
    when its APP1 cannot be parsed; a missing or unbuildable codec raises.
    A PNG gives its IHDR dimensions, `.npy` and `.exr` the dimensions of
    their pixels. Other formats go to PIL; what PIL cannot open gives the
    dimensions read from the pixels."""
    if _is_jpeg(path):
        from .exif import read_jpeg_exif

        with open(path, "rb") as f:
            return read_jpeg_exif(f.read())
    if path.lower().endswith(".png"):
        w, h = _png_size(path)
        return {"width": w, "height": h}
    meta: dict = {}
    if path.endswith((".npy", ".exr")):
        meta["height"], meta["width"] = read_image(path).shape[:2]
        return meta
    try:
        from PIL import ExifTags, Image

        with Image.open(path) as im:
            meta["width"], meta["height"] = im.size
            exif = im.getexif()
            if exif:
                tagmap = {ExifTags.TAGS.get(k, k): v for k, v in exif.items()}
                if "Make" in tagmap:
                    meta["make"] = str(tagmap["Make"]).strip()
                if "Model" in tagmap:
                    meta["model"] = str(tagmap["Model"]).strip()
                fl = tagmap.get("FocalLength")
                if fl is not None:
                    meta["focal_mm"] = float(fl)
    except Exception:
        if "width" not in meta:
            img = read_image(path)
            meta["height"], meta["width"] = img.shape[:2]
    return meta
