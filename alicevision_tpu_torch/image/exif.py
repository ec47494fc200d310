"""EXIF of a JPEG (the TIFF structure in its APP1 segment) and of a TIFF
file, read without PIL.

Counterpart of the EXIF half of `alicevision_tpu/image/io.py:78-100`,
which reads PIL's `Image.getexif()`. `read_jpeg_exif` (behind
`image/io.read_exif` for `.jpg` / `.jpeg`) returns the same keys:
`width`, `height` (from the SOF, as PIL's `im.size`), `make`, `model`
(ASCII, one trailing NUL dropped as PIL drops it, then whitespace
stripped) and `focal_mm`. Both byte orders (II, MM) are taken, and
FocalLength (37386) is read from IFD0 or from the Exif sub-IFD (pointer
34665). Cameras write it in the sub-IFD, where the reference reads it
(`Exif:FocalLength` through OIIO, main_cameraInit.cpp:323-343); the JAX
function reads IFD0 only and misses it there (ROADMAP §3, repaired in
the port only). An APP1 that cannot be parsed gives the dimensions
alone, as the JAX function's `except` does. `read_tiff_exif` reads the
same keys from a TIFF file's own IFD0 and Exif sub-IFD (behind
`image/io.read_exif` for `.tif` / `.tiff`).

`camera_tags` and `pack_ifd` build such IFDs (`image/tiff.assemble`
writes camera TIFFs with them); `exif_app1` builds such a segment (Make, Model, FocalLength as a
RATIONAL in IFD0 or the sub-IFD) and `insert_app1` splices it into a
JPEG: the smoke run and the tests write camera JPEGs with them.
"""

from __future__ import annotations

import math
import struct

from . import jpeg

WIDTH, HEIGHT, MAKE, MODEL, FOCAL_LENGTH, EXIF_IFD = 256, 257, 271, 272, 37386, 34665
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}
_FORMATS = {1: "B", 3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 11: "f", 12: "d"}


def _ifd(tiff: bytes, off: int, bo: str) -> dict:
    """{tag: value} of the IFD at `off`: ASCII as str, single numbers as int
    or float (RATIONALs divided out, nan over 0 as PIL gives), counts
    above one as tuples. Raises ValueError (or struct.error) when an entry
    points outside the segment."""
    (n,) = struct.unpack(bo + "H", tiff[off:off + 2])
    out = {}
    for i in range(n):
        e = off + 2 + 12 * i
        tag, typ, count = struct.unpack(bo + "HHL", tiff[e:e + 8])
        if typ not in _SIZES:
            continue  # a type PIL skips too
        size = _SIZES[typ] * count
        if size <= 4:
            data = tiff[e + 8:e + 8 + size]
        else:
            (ptr,) = struct.unpack(bo + "L", tiff[e + 8:e + 12])
            data = tiff[ptr:ptr + size]
        if len(data) != size:
            raise ValueError(f"EXIF tag {tag} points past its segment")
        if typ == 2:
            out[tag] = (data[:-1] if data.endswith(b"\0") else data).decode("latin-1", "replace")
            continue
        if typ == 7:
            out[tag] = data
            continue
        if typ in (5, 10):
            nums = struct.unpack(bo + ("L" if typ == 5 else "l") * (2 * count), data)
            vals = tuple(a / b if b else math.nan for a, b in zip(nums[::2], nums[1::2]))
        else:
            vals = struct.unpack(bo + _FORMATS[typ] * count, data)
        out[tag] = vals[0] if count == 1 else vals
    return out


def tiff_header(tiff: bytes) -> tuple:
    """(byte order "<" or ">", IFD0's offset) of a classic TIFF structure;
    raises ValueError naming BigTIFF or what is wrong."""
    order = tiff[:2]
    if order not in (b"II", b"MM"):
        raise ValueError(f"not a TIFF structure (byte order {order!r})")
    bo = "<" if order == b"II" else ">"
    (magic,) = struct.unpack(bo + "H", tiff[2:4])
    if magic == 43:
        raise ValueError("BigTIFF is not taken")
    if magic != 42:
        raise ValueError(f"not a TIFF structure (magic {magic})")
    (off,) = struct.unpack(bo + "L", tiff[4:8])
    return bo, off


def parse_tiff(tiff: bytes) -> tuple:
    """(IFD0, Exif sub-IFD) of a TIFF structure (the APP1 payload after
    `Exif\\0\\0`, or a TIFF file)."""
    bo, off = tiff_header(tiff)
    ifd0 = _ifd(tiff, off, bo)
    sub = {}
    ptr = ifd0.get(EXIF_IFD)
    if isinstance(ptr, int):
        sub = _ifd(tiff, ptr, bo)
    return ifd0, sub


def exif_fields(app1: bytes) -> dict:
    """make, model and focal_mm of one APP1 payload (`Exif\\0\\0` + TIFF)."""
    return _camera_fields(*parse_tiff(app1[6:]))


def _camera_fields(ifd0: dict, sub: dict) -> dict:
    meta = {}
    if MAKE in ifd0:
        meta["make"] = str(ifd0[MAKE]).strip()
    if MODEL in ifd0:
        meta["model"] = str(ifd0[MODEL]).strip()
    fl = ifd0.get(FOCAL_LENGTH, sub.get(FOCAL_LENGTH))
    if isinstance(fl, (int, float)):
        meta["focal_mm"] = float(fl)
    return meta


def read_jpeg_exif(data: bytes) -> dict:
    """The JAX read_exif's keys for the bytes of a JPEG."""
    meta = {}
    meta["width"], meta["height"] = jpeg.image_size(data)
    app1 = []
    for m, a, b, _ in jpeg._segments(data):
        if m == 0xE1 and data[a:a + 6] == b"Exif\0\0":
            app1.append(data[a:b])
        if m == 0xDA:
            break
    if app1:
        try:
            meta.update(exif_fields(app1[0]))
        except (ValueError, struct.error, UnicodeError):
            pass  # an unreadable APP1: the dimensions alone
    return meta


def camera_tags(make: str | None, model: str | None, focal_mm: float | None, bo: str,
                focal_in: str = "exif") -> tuple:
    """(IFD0 entries, Exif sub-IFD entries) for `pack_ifd`: Make, Model
    (ASCII) and FocalLength (a RATIONAL over 10000), the focal in IFD0
    (`focal_in="ifd0"`) or in the Exif sub-IFD (`"exif"`, where cameras
    write it), packed in byte order `bo` ("<" or ">")."""
    ifd0, sub = [], []
    if make is not None:
        ifd0.append((MAKE, 2, make.encode("latin-1") + b"\0"))
    if model is not None:
        ifd0.append((MODEL, 2, model.encode("latin-1") + b"\0"))
    if focal_mm is not None:
        entry = (FOCAL_LENGTH, 5, struct.pack(bo + "LL", round(focal_mm * 10000), 10000))
        (ifd0 if focal_in == "ifd0" else sub).append(entry)
    return ifd0, sub


def pack_ifd(entries: list, start: int, bo: str, link: int = 0) -> bytes:
    """An IFD at offset `start` of its TIFF structure, then the values that
    do not fit its entries. `entries` are (tag, type, packed value bytes);
    a value of None is a LONG holding `link` (a sub-IFD's offset)."""
    head, data = b"", b""
    data_off = start + 2 + 12 * len(entries) + 4
    for tag, typ, val in sorted(entries, key=lambda e: e[0]):
        if val is None:
            val = struct.pack(bo + "L", link)
        count = len(val) // _SIZES[typ]
        if len(val) <= 4:
            field = val.ljust(4, b"\0")
        else:
            field = struct.pack(bo + "L", data_off + len(data))
            data += val + b"\0" * (len(val) % 2)
        head += struct.pack(bo + "HHL", tag, typ, count) + field
    return struct.pack(bo + "H", len(entries)) + head + b"\0\0\0\0" + data


def read_tiff_exif(data: bytes) -> dict:
    """The JAX read_exif's keys for the bytes of a TIFF file: `width` and
    `height` from tags 256 and 257, make, model and focal from IFD0, the
    focal from the Exif sub-IFD where IFD0 has none (PIL's `getexif()`
    holds IFD0 only, so the JAX function misses it there). A BigTIFF or a
    file that is no TIFF raises ValueError."""
    ifd0, sub = parse_tiff(data)
    return {"width": int(ifd0[WIDTH]), "height": int(ifd0[HEIGHT]), **_camera_fields(ifd0, sub)}


def exif_app1(make: str | None = None, model: str | None = None, focal_mm: float | None = None,
              order: str = "II", focal_in: str = "exif") -> bytes:
    """An APP1 segment (marker and length included) holding Make, Model and
    FocalLength (`camera_tags`), in byte order II or MM."""
    bo = "<" if order == "II" else ">"
    ifd0, sub = camera_tags(make, model, focal_mm, bo, focal_in)
    if sub:
        ifd0.append((EXIF_IFD, 4, None))  # the sub-IFD's offset, known once IFD0 is packed
    sub_off = 8 + len(pack_ifd(ifd0, 8, bo))
    tiff = order.encode() + struct.pack(bo + "HL", 42, 8) + pack_ifd(ifd0, 8, bo, sub_off)
    if sub:
        tiff += pack_ifd(sub, sub_off, bo)
    payload = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


def insert_app1(data: bytes, app1: bytes) -> bytes:
    """`data` with the segment `app1` after its SOI and JFIF APP0."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    pos = 2
    if data[2:4] == b"\xff\xe0":
        (length,) = struct.unpack(">H", data[4:6])
        pos = 4 + length
    return data[:pos] + app1 + data[pos:]
