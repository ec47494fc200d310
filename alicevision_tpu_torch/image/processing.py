"""Image processing operations (the imageProcessing utility stage).

Port of `alicevision_tpu/image/processing.py`, the counterpart of the
reference's image-processing tool (ref:
src/software/utils/main_imageProcessing.cpp — resize, contrast,
sharpening, noise reduction, fill holes) and of split360
(src/software/utils/main_split360Images.cpp — equirect to pinhole crops).
All filters are torch ops on the image's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .filtering import bilinear_sample, gaussian_blur


@functools.lru_cache(maxsize=16)
def _linear_weights_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of `jax.image.resize(method="linear")`
    along one axis (its `compute_weight_mat` with antialias on): a
    triangle kernel widened by 1/scale when downsampling, each column
    normalized, zero for a sample outside the input."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(inv_scale) - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / np.float32(kernel_scale)
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x)).astype(np.float32)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps), w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize(img: torch.Tensor, scale: float) -> torch.Tensor:
    """Resize (H, W[, C]) by `scale` with `jax.image.resize`'s linear
    method: one weight matrix a resized axis, as two products."""
    H, W = img.shape[:2]
    h, w = int(round(H * scale)), int(round(W * scale))
    out = img
    if h != H:
        wh = torch.from_numpy(_linear_weights_np(H, h)).to(img.device)
        out = torch.einsum("h...,hk->k...", out, wh)
    if w != W:
        ww = torch.from_numpy(_linear_weights_np(W, w)).to(img.device)
        out = torch.einsum("hw...,wk->hk...", out, ww)
    return out


def sharpen(img: torch.Tensor, amount: float = 1.0, sigma: float = 1.0) -> torch.Tensor:
    """Unsharp masking."""
    blur = gaussian_blur(img, sigma)
    return torch.clamp(img + amount * (img - blur), 0.0, 1.0)


def adjust_contrast(img: torch.Tensor, factor: float = 1.2, pivot: float = 0.5) -> torch.Tensor:
    return torch.clamp((img - pivot) * factor + pivot, 0.0, 1.0)


def bilateral_denoise(
    img: torch.Tensor, sigma_spatial: float = 2.0, sigma_range: float = 0.1, radius: int = 3
) -> torch.Tensor:
    """Edge-preserving denoise via an explicit shifted-window bilateral
    filter (batched shifts — no data-dependent loops)."""
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            sh = torch.roll(img, (dy, dx), (0, 1))
            w_s = float(np.exp(-(dy * dy + dx * dx) / (2 * sigma_spatial**2)))
            w = w_s * torch.exp(-((sh - img) ** 2) / (2 * sigma_range**2))
            num = num + w * sh
            den = den + w
    return num / torch.clamp(den, min=1e-9)


def fill_holes(img: torch.Tensor, mask: torch.Tensor, iterations: int = 50) -> torch.Tensor:
    """Diffusion inpainting of masked-out pixels (fillHoles option)."""
    zero = torch.zeros_like(img)
    out = torch.where(mask, img, zero)
    w = mask.to(img.dtype)
    for _ in range(iterations):
        num = (
            torch.roll(out, 1, 0) * torch.roll(w, 1, 0)
            + torch.roll(out, -1, 0) * torch.roll(w, -1, 0)
            + torch.roll(out, 1, 1) * torch.roll(w, 1, 1)
            + torch.roll(out, -1, 1) * torch.roll(w, -1, 1)
        )
        den = torch.roll(w, 1, 0) + torch.roll(w, -1, 0) + torch.roll(w, 1, 1) + torch.roll(w, -1, 1)
        fill = num / torch.clamp(den, min=1e-9)
        known = w > 0
        newly = (den > 0) & ~known
        out = torch.where(mask, img, torch.where(newly | known, torch.where(known, out, fill), out))
        w = torch.maximum(w, newly.to(img.dtype))
    return out


def split_equirect(
    pano: torch.Tensor,  # (H, W) or (H, W, C)
    n_splits: int = 8,
    fov_deg: float = 90.0,
    out_size: int = 512,
    pitch_deg: float = 0.0,
):
    """Equirect panorama -> N pinhole crops around the horizon
    (main_split360Images equirectangular mode), on the panorama's device.
    Returns (imgs (N, s, s[, C]) tensor, K (3, 3) tensor, R (N, 3, 3) numpy
    world->cam rotations)."""
    from ..geometry.rotations import so3_exp
    from ..panorama.warping import direction_to_equirect

    dev = pano.device
    H, W = pano.shape[:2]
    f = out_size / (2.0 * np.tan(np.radians(fov_deg) / 2.0))
    K = torch.tensor([[f, 0, out_size / 2], [0, f, out_size / 2], [0, 0, 1.0]], dtype=torch.float32, device=dev)
    ys = torch.arange(out_size, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, ys, indexing="ij")
    d_cam = torch.stack([(gx - out_size / 2) / f, (gy - out_size / 2) / f, torch.ones_like(gx)], -1)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)

    pitch = np.radians(pitch_deg)
    Rp = so3_exp(torch.tensor([pitch, 0.0, 0.0], dtype=torch.float32))
    imgs, Rs = [], []
    for i in range(n_splits):
        yaw = 2 * np.pi * i / n_splits
        R = (Rp @ so3_exp(torch.tensor([0.0, yaw, 0.0], dtype=torch.float32))).numpy()
        d_world = torch.einsum("ji,hwj->hwi", torch.as_tensor(R, device=dev), d_cam)
        uv = direction_to_equirect(d_world, (W, H))
        if pano.ndim == 2:
            img = bilinear_sample(pano, uv)
        else:
            img = torch.stack([bilinear_sample(pano[..., c], uv) for c in range(pano.shape[-1])], -1)
        imgs.append(img)
        Rs.append(R)
    return torch.stack(imgs), K, np.stack(Rs)


# ---------------------------------------------------------------------------
# Lens correction profiles (LCP) and DNG camera profiles (DCP) applied to
# images — the reference parses these in lensCorrectionProfile/ and image/dcp
# and applies them in main_imageProcessing.cpp (lensCorrection options).
# ---------------------------------------------------------------------------


def _pixel_grid(H: int, W: int, device):
    return torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device),
        indexing="ij",
    )


def apply_lcp_geometry(img: torch.Tensor, alt) -> torch.Tensor:
    """Undistort an image with an LCP rectilinear model: each undistorted
    output pixel samples the source at the FORWARD-distorted position
    r_d = r_u (1 + k1 r^2 + k2 r^4 + k3 r^6) (inverse warp, no iteration).
    Conventions match the reference's undistortRectilinearGeometryLCP
    (main_imageProcessing.cpp:460-497): principal point = center fractions
    of W/H, focal = fraction of max(W, H). Works on (H, W) or (H, W, C)."""
    chans = img.ndim == 3
    im = torch.movedim(img, -1, 0) if chans else img[None]
    H, W = im.shape[-2:]
    dmax = float(max(H, W))
    pp_x, pp_y = alt.cx * W, alt.cy * H
    sc_x = max(alt.focal_x, 1e-9) * dmax
    sc_y = max(alt.focal_y, 1e-9) * dmax
    gy, gx = _pixel_grid(H, W, img.device)
    u = (gx - pp_x) / sc_x
    v = (gy - pp_y) / sc_y
    r2 = u * u + v * v
    k1, k2, k3 = alt.radial
    scale = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xy = torch.stack([u * scale * sc_x + pp_x, v * scale * sc_y + pp_y], -1)
    out = torch.stack([bilinear_sample(c, xy) for c in im])
    return torch.movedim(out, 0, -1) if chans else out[0]


def apply_lcp_vignette(img: torch.Tensor, alt) -> torch.Tensor:
    """Devignette with the Adobe model g(r) = 1 + v1 r^2 + v2 r^4 + v3 r^6
    inverted as a 4th-order power series and MULTIPLIED in — the exact
    scheme of the reference's undistortVignetting
    (main_imageProcessing.cpp:427-458), including its width/height
    normalization of r."""
    vg = getattr(alt, "vignette", ())
    if not vg:
        return img
    v1, v2, v3 = (list(vg) + [0.0, 0.0])[:3]
    p1 = -v1
    p2 = v1 * v1 - v2
    p3 = -(v1**3 - 2 * v1 * v2 + v3)
    p4 = v1**4 + v2 * v2 + 2 * v1 * v3 - 3 * v1 * v1 * v2
    H, W = img.shape[:2]
    gy, gx = _pixel_grid(H, W, img.device)
    u = (gx / W - alt.cx) / max(alt.focal_x, 1e-9)
    v = (gy / H - alt.cy) / max(alt.focal_y, 1e-9)
    r2 = u * u + v * v
    gain = 1.0 + r2 * (p1 + r2 * (p2 + r2 * (p3 + r2 * p4)))
    return img * (gain[..., None] if img.ndim == 3 else gain)
