"""Specular/calibration sphere detection (classical Hough voting).

Port of `alicevision_tpu/misc/sphere_detection.py`: host numpy and scipy as
there (tiny accumulators), copied; `detect_sphere_onnx` runs its network on
the device through `misc/segmentation`. Counterpart of the reference's ONNX
sphereDetection module
(ref: src/aliceVision/sphereDetection/sphereDetection.cpp — network-based
sphere localization feeding lighting calibration). Circles are found by
gradient-direction Hough voting over a radius sweep, with accumulators in
numpy on the host.
"""

from __future__ import annotations

import numpy as np


def detect_sphere(
    image: np.ndarray,  # (H, W) grayscale [0, 1]
    r_min: int = 8,
    r_max: int = 64,
    n_radii: int = 15,
    grad_thresh: float = 0.05,
):
    """Detect the strongest circle. Returns (cx, cy, r, score)."""
    import scipy.ndimage as ndi

    img = ndi.gaussian_filter(image.astype(np.float64), 1.5)
    gy, gx = np.gradient(img)
    mag = np.hypot(gx, gy)
    H, W = img.shape
    ys, xs = np.nonzero(mag > grad_thresh)
    if len(ys) == 0:
        return None
    nx = gx[ys, xs] / mag[ys, xs]
    ny = gy[ys, xs] / mag[ys, xs]
    w = mag[ys, xs]

    best = None
    radii = np.unique(np.linspace(r_min, r_max, n_radii).astype(int))
    for r in radii:
        acc = np.zeros((H, W))
        # bright sphere on dark bg: gradient points outward -> center is
        # at -r * n; vote both directions to cover dark-on-bright too
        for sgn in (+1, -1):
            cx = np.round(xs + sgn * r * nx).astype(int)
            cy = np.round(ys + sgn * r * ny).astype(int)
            ok = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
            np.add.at(acc, (cy[ok], cx[ok]), w[ok])
        acc = ndi.gaussian_filter(acc, 2.0)
        peak = np.unravel_index(np.argmax(acc), acc.shape)
        score = acc[peak] / (2 * np.pi * r)  # normalize by circumference
        if best is None or score > best[3]:
            best = (int(peak[1]), int(peak[0]), int(r), float(score))
    return best


def sphere_mask(shape, cx, cy, r) -> np.ndarray:
    ys, xs = np.mgrid[0 : shape[0], 0 : shape[1]]
    return (xs - cx) ** 2 + (ys - cy) ** 2 <= r * r


def detect_sphere_onnx(image, model_path: str, threshold: float = 0.5, device="cuda"):
    """ONNX-model sphere detection (ref: sphereDetection/ — ONNX scores ->
    circle fit), the network on `device` through `misc/segmentation`.
    Returns (cx, cy, r) or None."""
    from .segmentation import onnx_model, segment_tiled

    run = onnx_model(model_path, device=device)
    img = np.asarray(image, np.float32)
    scores = segment_tiled(img if img.ndim == 3 else img[..., None], run)
    if scores.ndim == 3:  # multi-class model: class 0 is the sphere score
        scores = scores[..., 0]
    mask = scores > threshold
    if mask.sum() < 16:
        return None
    ys, xs = np.nonzero(mask)
    cx, cy = xs.mean(), ys.mean()
    r = np.sqrt(mask.sum() / np.pi)
    return float(cx), float(cy), float(r)
