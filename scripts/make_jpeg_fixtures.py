#!/usr/bin/env python3
"""Write the port's JPEG fixtures and their PIL oracle.

    python3 scripts/make_jpeg_fixtures.py

Writes a handful of small JPEGs under
`alicevision_tpu_torch/data/jpeg_fixtures/` (each subsampling, grey,
progressive, restart intervals, EXIF in IFD0 and in the Exif sub-IFD in
both byte orders; under 100 KB in all) and beside them `fixtures.json`:
for each file the shape and SHA-256 of PIL's decoded pixels and the EXIF
PIL reads (Make and Model from IFD0, FocalLength from IFD0 or the Exif
sub-IFD, as the reference reads `Exif:FocalLength`). The card's machine
has no PIL: `chip_smoke.py`'s `photos` phase holds the port's decoder and
EXIF reader to this file there. Needs PIL and cv2 (4:4:0); the images are
seeded numpy, so a rerun writes the same files.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from alicevision_tpu_torch.image import exif  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "alicevision_tpu_torch", "data", "jpeg_fixtures")
CAMERA = dict(make="Canon", model="Canon EOS 5D Mark III", focal_mm=31.5)


def photo(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 9 + c) * np.cos(y / 6 - c) for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)


def pil_jpeg(img: np.ndarray, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, format="JPEG", **kw)
    return b.getvalue()


def cv2_jpeg(img: np.ndarray, factor: int, quality: int) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
    assert ok
    return buf.tobytes()


def fixtures() -> dict:
    img = photo(47, 61, 0)
    cam = pil_jpeg(img, quality=90)
    return {
        "s444.jpg": pil_jpeg(img, quality=90, subsampling=0),
        "s422.jpg": pil_jpeg(img, quality=85, subsampling=1),
        "s420.jpg": pil_jpeg(photo(50, 70, 1), quality=75, subsampling=2),
        "s440.jpg": cv2_jpeg(img, 0x121111, 90),
        "grey.jpg": pil_jpeg(img[..., 1], quality=80),
        "progressive.jpg": pil_jpeg(photo(64, 48, 2), quality=92, progressive=True),
        "progressive_grey.jpg": pil_jpeg(photo(31, 45, 3)[..., 0], quality=70, progressive=True),
        "restart.jpg": pil_jpeg(photo(40, 72, 4), quality=95, restart_marker_blocks=2),
        "optimized.jpg": pil_jpeg(photo(33, 17, 5), quality=100, optimize=True),
        "exif_ifd0_ii.jpg": exif.insert_app1(cam, exif.exif_app1(**CAMERA, order="II", focal_in="ifd0")),
        "exif_ifd0_mm.jpg": exif.insert_app1(cam, exif.exif_app1(**CAMERA, order="MM", focal_in="ifd0")),
        "exif_sub_ii.jpg": exif.insert_app1(cam, exif.exif_app1(**CAMERA, order="II", focal_in="exif")),
        "exif_sub_mm.jpg": exif.insert_app1(cam, exif.exif_app1(**CAMERA, order="MM", focal_in="exif")),
    }


def pil_exif(path: str) -> dict:
    """Make and Model from IFD0, FocalLength from IFD0 or the Exif sub-IFD."""
    with Image.open(path) as im:
        e = im.getexif()
        out = {}
        if 271 in e:
            out["make"] = str(e[271]).strip()
        if 272 in e:
            out["model"] = str(e[272]).strip()
        fl = e.get(37386, e.get_ifd(0x8769).get(37386))
        if fl is not None:
            out["focal_mm"] = float(fl)
        return out


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    table = {}
    for name, data in fixtures().items():
        path = os.path.join(OUT, name)
        with open(path, "wb") as f:
            f.write(data)
        pix = np.asarray(Image.open(path))
        table[name] = {"shape": list(pix.shape), "sha256": hashlib.sha256(pix.tobytes()).hexdigest(),
                       "exif": pil_exif(path)}
    with open(os.path.join(OUT, "fixtures.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in table)
    print(f"{len(table)} fixtures, {total} bytes, in {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
