"""Host-side image IO and EXIF metadata (a numpy copy of
`alicevision_tpu/image/io.py`).

The JAX package reads and writes images through imageio (Pillow, and the
tifffile bundled with imageio) and EXIF through PIL. The port reads and
writes these formats with its own code, with no image codec library (the
card's machine has none), and never imports imageio, PIL or cv2 for them:

- `.npy`, with numpy alone;
- EXR, through the port's scanline reader and writer (`image/exr.py`);
- PNG (`image/png.py`): every bit depth and colour type, palettes,
  `tRNS`, Adam7; written as 8- or 16-bit;
- JPEG (`.jpg`, `.jpeg`), through the port's codec (`image/jpeg.py` over
  `native/jpeg.cpp`: decoded byte-equal to libjpeg-turbo; written as PIL
  writes it at quality 75, 4:2:0);
- TIFF (`.tif`, `.tiff`; `image/tiff.py`): 8- and 16-bit and float,
  uncompressed, LZW, deflate or PackBits, predictors, strips and tiles;
  written baseline and uncompressed, as imageio writes it;
- BMP (`image/bmp.py`): palette, RLE, 24- and 32-bit; written as Pillow
  writes it.

Each returns the dtype and shape imageio returns, with two partings that
follow the reference (OIIO): a 16-bit RGB, RGBA or grey + alpha PNG keeps
its 16 bits, and a TIFF of PlanarConfiguration 2 comes out (H, W, S), not
(S, H, W) (ROADMAP §3). A variant a reader does not take raises a
ValueError naming it; when the C++ of `native/` cannot be built, the PNG,
JPEG and TIFF readers raise. `read_exif` reads a JPEG's EXIF
(`image/exif.py`), a TIFF's own IFD0 and Exif sub-IFD, and the
dimensions of PNG and BMP headers, with no PIL.

Other formats (GIF, WebP, ...) still go to imageio, and their EXIF to PIL,
imported lazily, as the reference does (ROADMAP §2).
"""

from __future__ import annotations

import mmap
import os

import numpy as np

from .png import PNG_SIG as _PNG_SIG, _chunk as _png_chunk, _unfilter, read_png, write_png  # noqa: F401

_GRAY = np.array([0.299, 0.587, 0.114], np.float32)  # Rec.601 (OIIO)
_CODECS = {".jpg": "jpeg", ".jpeg": "jpeg", ".png": "png", ".tif": "tiff", ".tiff": "tiff", ".bmp": "bmp"}


def _codec(path: str):
    """The port's own codec for `path`'s extension, or None."""
    return _CODECS.get(os.path.splitext(path)[1].lower())


def _read_own(path: str, kind: str) -> np.ndarray:
    if kind == "png":
        return read_png(path)
    if kind == "jpeg":
        from .jpeg import read_jpeg

        return read_jpeg(path)
    if kind == "tiff":
        from .tiff import read_tiff

        return read_tiff(path)
    from .bmp import read_bmp

    return read_bmp(path)


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
    kind = _codec(path)
    if kind is not None:
        img = _read_own(path, kind)
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
    kind = _codec(path)
    if kind == "png":
        write_png(path, img)
        return
    if kind == "jpeg":
        from .jpeg import write_jpeg

        write_jpeg(path, img)
        return
    if kind == "tiff":
        from .tiff import write_tiff

        write_tiff(path, img)
        return
    if kind == "bmp":
        from .bmp import write_bmp

        write_bmp(path, img)
        return
    import imageio.v2 as imageio

    imageio.imwrite(path, img)


def read_exif(path: str) -> dict:
    """Best-effort EXIF: make, model, focal length (mm), dimensions. A JPEG
    or a TIFF goes to the port's reader (`image/exif.py`): the dimensions
    from the SOF or tags 256 and 257, the fields from IFD0 or the Exif
    sub-IFD (a JPEG whose APP1 cannot be parsed gives the dimensions
    alone); a missing or unbuildable codec raises. A PNG or a BMP gives its
    header's dimensions, `.npy` and `.exr` the dimensions of their pixels.
    Other formats go to PIL; what PIL cannot open gives the dimensions read
    from the pixels."""
    kind = _codec(path)
    if kind is not None:
        from . import exif
        from .bmp import bmp_size
        from .png import png_size

        with open(path, "rb") as f:
            if kind == "tiff":  # its IFD may follow the pixels: map the file rather than read it
                with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
                    return exif.read_tiff_exif(m)
            data = f.read()
        if kind == "jpeg":
            return exif.read_jpeg_exif(data)
        w, h = (png_size if kind == "png" else bmp_size)(data)
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
