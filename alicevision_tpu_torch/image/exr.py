"""Native OpenEXR scanline IO — no OpenEXR/OIIO library required.

A copy of `alicevision_tpu/image/exr.py` (host numpy, `struct`, `zlib`).

The reference stores depth/similarity maps and undistorted images as EXR
via OIIO (ref: src/aliceVision/image/io.cpp:13-17, mvsUtils/mapIO.hpp) —
this image's cv2 build ships no EXR codec, so the format is implemented
directly: single-part scanline files, float32/half channels, NONE or
ZIP/ZIPS compression (zlib + the EXR byte-delta/deinterleave predictor).
Writes use float32 + ZIP. Covers everything the pipeline and the
reference's own outputs need (multi-part/tiled/deep files are out of
scope and raise).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 0x01312F76

_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_PT_NP = {_PT_UINT: np.uint32, _PT_HALF: np.float16, _PT_FLOAT: np.float32}


def _read_cstr(buf, i):
    j = buf.index(b"\x00", i)
    return buf[i:j].decode("latin-1"), j + 1


def _predictor_decode(raw: bytes) -> bytes:
    """EXR zip reconstruction: undo byte delta, then de-interleave halves.
    Vectorized: d[i] = d[i-1] + e[i] - 128 is a cumulative sum mod 256."""
    e = np.frombuffer(raw, np.uint8).astype(np.int64)
    d = ((np.cumsum(e - 128) + 128) % 256).astype(np.uint8)
    n = len(d)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


def _predictor_encode(raw: bytes) -> bytes:
    """Inverse of _predictor_decode (interleave split + byte delta)."""
    r = np.frombuffer(raw, np.uint8)
    n = len(r)
    half = (n + 1) // 2
    d = np.empty(n, np.uint8)
    d[:half] = r[0::2]
    d[half:] = r[1::2]
    di = d.astype(np.int64)
    out = np.empty(n, np.uint8)
    out[0] = d[0]
    out[1:] = ((di[1:] - di[:-1] + 128) % 256).astype(np.uint8)
    return out.tobytes()


def read_exr(path: str) -> np.ndarray:
    """Read a single-part scanline EXR -> float32 (H, W) or (H, W, C).

    RGB(A) channel sets come back in R,G,B[,A] order; other channel sets
    in alphabetical order (the file's storage order)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<iI", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200 or version & 0x800 or version & 0x1000:
        raise ValueError(f"{path}: tiled/deep/multi-part EXR not supported")

    i = 8
    channels = []  # (name, pixel_type)
    compression = 0
    data_window = None
    while True:
        if buf[i] == 0:
            i += 1
            break
        name, i = _read_cstr(buf, i)
        typ, i = _read_cstr(buf, i)
        (size,) = struct.unpack_from("<i", buf, i)
        i += 4
        val = buf[i : i + size]
        i += size
        if name == "channels":
            j = 0
            while val[j] != 0:
                cname, j = _read_cstr(val, j)
                (ptype,) = struct.unpack_from("<i", val, j)
                channels.append((cname, ptype))
                j += 16  # pixelType + pLinear/reserved + x/ySampling
        elif name == "compression":
            compression = val[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", val)

    if data_window is None or not channels:
        raise ValueError(f"{path}: missing dataWindow/channels")
    x0, y0, x1, y1 = data_window
    W, H = x1 - x0 + 1, y1 - y0 + 1
    # compression: 0 NONE, 2 ZIPS (1 line), 3 ZIP (16 lines)
    if compression not in (0, 2, 3):
        raise ValueError(
            f"{path}: compression {compression} not supported (NONE/ZIP/ZIPS only)"
        )
    lines_per_block = {0: 1, 2: 1, 3: 16}[compression]

    n_blocks = (H + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, i)

    planes = {c: np.zeros((H, W), _PT_NP[t]) for c, t in channels}
    chan_order = sorted(channels)  # storage order: alphabetical
    for off in offsets:
        y, dsize = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8 : off + 8 + dsize]
        ny = min(lines_per_block, y1 - y + 1)
        raw_size = sum(ny * W * np.dtype(_PT_NP[t]).itemsize for _, t in channels)
        if compression and dsize < raw_size:
            data = _predictor_decode(zlib.decompress(data))
        j = 0
        for line in range(ny):
            for cname, ptype in chan_order:
                nb = W * np.dtype(_PT_NP[ptype]).itemsize
                planes[cname][y - y0 + line] = np.frombuffer(
                    data[j : j + nb], _PT_NP[ptype]
                )
                j += nb

    names = [c for c, _ in chan_order]
    if len(names) == 1:
        return planes[names[0]].astype(np.float32)
    order = names
    if set("RGB").issubset(names):
        order = ["R", "G", "B"] + (["A"] if "A" in names else [])
        order += [n for n in names if n not in order]
    return np.stack([planes[n].astype(np.float32) for n in order], axis=-1)


def write_exr(path: str, img: np.ndarray, channel_names=None) -> None:
    """Write float32 (H, W) or (H, W, C) as a ZIP-compressed scanline EXR."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
        names = channel_names or ["Y"]
    else:
        c = img.shape[-1]
        names = channel_names or (
            ["R", "G", "B", "A"][:c] if c <= 4 else [f"c{k}" for k in range(c)]
        )
    H, W, C = img.shape
    chan_order = sorted(range(C), key=lambda k: names[k])

    def attr(name, typ, data):
        return name.encode() + b"\x00" + typ.encode() + b"\x00" + struct.pack(
            "<i", len(data)
        ) + data

    chdata = b""
    for k in chan_order:
        chdata += names[k].encode() + b"\x00" + struct.pack(
            "<iBBBBii", _PT_FLOAT, 0, 0, 0, 0, 1, 1
        )
    chdata += b"\x00"
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = (
        attr("channels", "chlist", chdata)
        + attr("compression", "compression", bytes([3]))  # ZIP
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", bytes([0]))
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\x00"
    )

    lines_per_block = 16
    n_blocks = (H + lines_per_block - 1) // lines_per_block
    blocks = []
    for b in range(n_blocks):
        y = b * lines_per_block
        ny = min(lines_per_block, H - y)
        raw = b"".join(
            img[y + line, :, k].tobytes()
            for line in range(ny)
            for k in chan_order
        )
        comp = zlib.compress(_predictor_encode(raw))
        if len(comp) >= len(raw):
            comp = raw  # EXR stores raw when compression does not help
        blocks.append((y, comp))

    head = struct.pack("<iI", _MAGIC, 2) + header
    table_pos = len(head)
    data_pos = table_pos + 8 * n_blocks
    offsets = []
    for y, comp in blocks:
        offsets.append(data_pos)
        data_pos += 8 + len(comp)
    with open(path, "wb") as f:
        f.write(head)
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))
        for y, comp in blocks:
            f.write(struct.pack("<ii", y, len(comp)))
            f.write(comp)
