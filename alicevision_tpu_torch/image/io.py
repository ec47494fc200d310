"""Host-side image IO (a numpy copy of `alicevision_tpu/image/io.py`'s
read/write pair).

`.npy` is read and written with numpy alone; it is the image format of the
dense path on machines without an image codec library. Other formats import
`imageio` lazily, as the reference does. EXR IO waits for the port of
`image/exr.py`.
"""

from __future__ import annotations

import numpy as np

_GRAY = np.array([0.299, 0.587, 0.114], np.float32)  # Rec.601 (OIIO)


def read_image(path: str, grayscale: bool = False) -> np.ndarray:
    """Read an image -> float32 in [0, 1], (H, W[, 3])."""
    if path.endswith(".npy"):
        img = np.load(path)
    elif path.endswith(".exr"):
        raise NotImplementedError(
            "EXR images are read once image/exr.py is ported (ROADMAP queue 1, "
            "the features slice)"
        )
    else:
        import imageio.v2 as imageio

        img = imageio.imread(path)
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
        raise NotImplementedError(
            "EXR images are written once image/exr.py is ported (ROADMAP "
            "queue 1, the features slice)"
        )
    import imageio.v2 as imageio

    if img.dtype in (np.float32, np.float64):
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    imageio.imwrite(path, img)
