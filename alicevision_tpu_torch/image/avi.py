"""Motion-JPEG AVI reader of the port, with no OpenCV.

Counterpart of the container half of `alicevision_tpu/image/feeds.py`'s
`video_feed`, which reads video through `cv2.VideoCapture` (FFmpeg). The
reader walks the RIFF tree, never scanning for byte patterns (an AVI holds
chunk ids inside its index headers too):

- `hdrl`: `avih`, then each `strl`'s `strh` and, for the video stream
  (`vids`), `strf`'s BITMAPINFOHEADER: width, height, `biCompression`;
- `movi`: the video stream's `##dc` / `##db` chunks in file order, inside
  `LIST rec ` too; `JUNK`, `ix##`, `indx`, `idx1` and other streams'
  chunks are skipped;
- the OpenDML `RIFF AVIX` parts that follow the first `RIFF AVI `.

A zero-length frame chunk (a dropped frame) yields no frame, as
`cv2.VideoCapture` yields none. The codec must be Motion JPEG (`MJPG`):
each frame decodes through `image/jpeg.decode`, so it equals
libjpeg-turbo's (PIL's) decode of the chunk; an AVI1 frame with no DHT
takes the Annex K tables, as libjpeg-turbo does. FFmpeg's own MJPEG
decoder (behind cv2) differs from libjpeg-turbo by a few levels, up to
tens at hard chroma edges (ROADMAP §3). Any other codec, and MP4, MOV and
Matroska containers, raise a ValueError naming them.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_MJPEG = (b"MJPG", b"mjpg")
_CONTAINERS = {".mp4": "MP4", ".mov": "QuickTime (MOV)", ".mkv": "Matroska"}


def _chunks(data, start: int, end: int):
    """(id, payload start, payload end, list type or None) of each chunk
    in data[start:end]; a LIST or RIFF chunk's payload starts after its
    type."""
    pos = start
    while pos + 8 <= end:
        cid = bytes(data[pos:pos + 4])
        (size,) = struct.unpack("<L", data[pos + 4:pos + 8])
        body, stop = pos + 8, min(pos + 8 + size, end)
        if cid in (b"LIST", b"RIFF"):
            yield cid, body + 4, stop, bytes(data[body:body + 4])
        else:
            yield cid, body, stop, None
        pos = pos + 8 + size + (size & 1)


def container_error(path: str, data) -> str | None:
    """The name of a non-AVI video container `path` holds, or None."""
    ext = os.path.splitext(path)[1].lower()
    if ext in _CONTAINERS:
        return _CONTAINERS[ext]
    if bytes(data[4:8]) == b"ftyp":
        return "MP4"
    if bytes(data[:4]) == b"\x1a\x45\xdf\xa3":
        return "Matroska"
    return None


def parse(data) -> dict:
    """The video stream of an AVI: {width, height, codec, stream, frames:
    [(offset, size), ...] of its non-empty frame chunks in file order}."""
    if bytes(data[:4]) != b"RIFF" or bytes(data[8:12]) != b"AVI ":
        raise ValueError("not an AVI file (no RIFF AVI header)")
    info = dict(width=0, height=0, codec=None, stream=None, frames=[])
    streams = 0

    def header(start, end):
        nonlocal streams
        for cid, a, b, kind in _chunks(data, start, end):
            if kind == b"strl":
                fcc_type, handler, bih = None, None, None
                for sid, sa, sb, _ in _chunks(data, a, b):
                    if sid == b"strh":
                        fcc_type, handler = bytes(data[sa:sa + 4]), bytes(data[sa + 4:sa + 8])
                    elif sid == b"strf":
                        bih = bytes(data[sa:sb])
                if fcc_type == b"vids" and info["stream"] is None:
                    info["stream"] = streams
                    if bih is not None and len(bih) >= 20:
                        w, h, comp = struct.unpack("<ll4x4s", bih[4:20])
                        info.update(width=w, height=abs(h), codec=comp)
                    else:
                        info["codec"] = handler
                streams += 1

    def movi(start, end, tags):
        for cid, a, b, kind in _chunks(data, start, end):
            if kind == b"rec ":
                movi(a, b, tags)
            elif cid in tags and b > a:
                info["frames"].append((a, b - a))

    tags = None
    for cid, a, b, kind in _chunks(data, 0, len(data)):
        if cid != b"RIFF" or kind not in (b"AVI ", b"AVIX"):
            continue
        for sid, sa, sb, skind in _chunks(data, a, b):
            if skind == b"hdrl":
                header(sa, sb)
            elif skind == b"movi":
                if info["stream"] is None:
                    raise ValueError("AVI with no video stream")
                if tags is None:
                    n = b"%02d" % info["stream"]
                    tags = (n + b"dc", n + b"db")
                movi(sa, sb, tags)
    if info["stream"] is None:
        raise ValueError("AVI with no video stream")
    if info["codec"] not in _MJPEG:
        name = info["codec"].decode("latin-1", "replace").strip("\0 ") if info["codec"] else "none"
        raise ValueError(f"AVI codec {name} is not taken (Motion JPEG only)")
    return info


def read_frames(path: str, stride: int = 1):
    """Yield (RGB uint8 (H, W, 3) frame, index) of an MJPEG AVI's frames,
    every `stride`-th, indices counted over all frames."""
    import mmap

    from . import jpeg

    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as data:
        err = container_error(path, data)
        if err is not None:
            raise ValueError(f"video container {err} is not taken (MJPEG AVI only)")
        info = parse(data)
        for i, (off, size) in enumerate(info["frames"]):
            if i % stride:
                continue
            img = jpeg.decode(bytes(data[off:off + size]))
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, axis=2)
            yield img, i
