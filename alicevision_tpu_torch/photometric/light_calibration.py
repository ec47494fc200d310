"""Directional-light calibration from a mirror/glossy sphere.

Port of `alicevision_tpu/photometric/light_calibration.py` (ref:
src/aliceVision/lightingEstimation/lightingCalibration.cpp —
`brightestPoint` method: detect the specular highlight on a known sphere,
convert it to a surface normal, reflect the view direction). The highlight
search is a Gaussian-smoothed argmax inside the sphere, on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..image.filtering import gaussian_blur


def sphere_normal_at(cx, cy, r, px, py):
    """Outward unit normal of the sphere at image point (px, py); the camera
    looks down +z, the sphere surface towards the camera has n_z < 0."""
    nx = (px - cx) / r
    ny = (py - cy) / r
    nz2 = max(0.0, 1.0 - nx * nx - ny * ny)
    return np.array([nx, ny, -np.sqrt(nz2)])


def calibrate_light_from_sphere(img, cx: float, cy: float, r: float, blur_sigma: float = 2.0,
                                device="cuda") -> np.ndarray:
    """Unit light direction (from the scene towards the light) from the
    brightest point on the sphere (lightingCalibration.cpp
    calibrateLightFromBrightestPoint). img (H, W) or (H, W, C), a tensor (on
    its device) or a host array (on `device`)."""
    if not isinstance(img, torch.Tensor):
        img = torch.as_tensor(np.asarray(img), dtype=torch.float32, device=resolve_device(device))
    gray = img if img.ndim == 2 else img.mean(-1)
    sm = gaussian_blur(gray.to(torch.float32), blur_sigma)
    H, W = sm.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=sm.device),
                            torch.arange(W, dtype=torch.float64, device=sm.device), indexing="ij")
    inside = (xs - cx) ** 2 + (ys - cy) ** 2 <= (0.95 * r) ** 2
    iy, ix = divmod(int(torch.where(inside, sm, torch.full_like(sm, -torch.inf)).reshape(-1).argmax()), W)
    n = sphere_normal_at(cx, cy, r, float(ix), float(iy))
    # view direction from surface to camera is -z axis
    v = np.array([0.0, 0.0, -1.0])
    light = 2.0 * np.dot(n, v) * n - v
    return light / np.linalg.norm(light)


def calibrate_lights(images, spheres, device="cuda") -> np.ndarray:
    """One light per image. spheres: (N, 3) of (cx, cy, r) or a single (3,)
    shared sphere."""
    spheres = np.asarray(spheres, float)
    if spheres.ndim == 1:
        spheres = np.tile(spheres, (len(images), 1))
    return np.stack([calibrate_light_from_sphere(im, s[0], s[1], s[2], device=device)
                     for im, s in zip(images, spheres)])
