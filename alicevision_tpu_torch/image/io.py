"""Host-side image IO and EXIF metadata (a numpy copy of
`alicevision_tpu/image/io.py`).

`.npy` is read and written with numpy alone; it is the image format of the
main path on machines without an image codec library. EXR goes through the
port's own scanline reader and writer (`image/exr.py`). Other formats, and
EXIF, import `imageio` and PIL lazily, as the reference does.
"""

from __future__ import annotations

import os

import numpy as np

_GRAY = np.array([0.299, 0.587, 0.114], np.float32)  # Rec.601 (OIIO)


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


def read_image(path: str, grayscale: bool = False) -> np.ndarray:
    """Read an image -> float32 in [0, 1], (H, W[, 3])."""
    if path.endswith(".npy"):
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
    import imageio.v2 as imageio

    if img.dtype in (np.float32, np.float64):
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    imageio.imwrite(path, img)


def read_exif(path: str) -> dict:
    """Best-effort EXIF: make, model, focal length (mm), dimensions. Files
    PIL cannot open (`.npy`, `.exr`, or no PIL at all) give their
    dimensions only, read from the pixels."""
    meta: dict = {}
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
