"""Image filtering primitives: separable Gaussian blur, gradients,
resampling and bilinear sampling.

Port of `alicevision_tpu/image/filtering.py`. Both blurs are one
formulation here: two banded matrix products, out = B_H @ img @ B_W^T, where
each band matrix folds the edge replication of the padded convolution into
its first and last columns. On a CUDA device a float32 matrix product runs
in full float32 as long as `torch.backends.cuda.matmul.allow_tf32` is False
(PyTorch's default), whereas a float32 `conv2d` would run in TF32 unless
`torch.backends.cudnn.allow_tf32` is turned off — the matrix form keeps the
blur at float32 precision without depending on the cuDNN switch.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _radius(sigma: float, radius: int | None) -> int:
    return max(1, int(math.ceil(3.0 * sigma))) if radius is None else radius


def gaussian_kernel_1d(sigma: float, radius: int | None = None, device=None) -> torch.Tensor:
    radius = _radius(sigma, radius)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


@functools.lru_cache(maxsize=64)
def _band_matrix_np(n: int, sigma: float, radius: int | None) -> np.ndarray:
    """Banded (n, n) blur matrix with edge-replication semantics —
    out[i] = sum_o k[o] * x[clip(i + o)] exactly like the padded conv."""
    radius = _radius(sigma, radius)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    M = np.zeros((n, n), np.float32)
    idx = np.arange(n)
    for o, kv in zip(range(-radius, radius + 1), k):
        M[idx, np.clip(idx + o, 0, n - 1)] += kv
    return M


@functools.lru_cache(maxsize=64)
def _band_matrix(n: int, sigma: float, radius: int | None, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_band_matrix_np(n, sigma, radius)).to(device)


def gaussian_blur_mm(img: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur on (..., H, W) as two banded matrix products."""
    if sigma <= 0:
        return img
    H, W = img.shape[-2], img.shape[-1]
    BW = _band_matrix(W, float(sigma), radius, img.device)
    BH = _band_matrix(H, float(sigma), radius, img.device)
    return torch.matmul(BH, torch.matmul(img, BW.T))


# One formulation serves both of the reference's blurs (see module note).
gaussian_blur = gaussian_blur_mm


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """Decimate by 2 (every other pixel), matching scale-space conventions."""
    return img[..., ::2, ::2]


def upsample2(img: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample of (..., H, W). `jax.image.resize`'s bilinear
    drops the weight of taps outside the image and renormalizes, which at
    2x is the edge replication of half-pixel-centred interpolation."""
    h, w = img.shape[-2], img.shape[-1]
    x = img.reshape((-1, 1, h, w))
    out = torch.nn.functional.interpolate(x, size=(2 * h, 2 * w), mode="bilinear", align_corners=False)
    return out.reshape(img.shape[:-2] + (2 * h, 2 * w))


def gradients(img: torch.Tensor):
    """Central-difference gradients (gx, gy) on (..., H, W), wrapping at the
    borders as the reference's roll does."""
    gx = 0.5 * (torch.roll(img, -1, dims=-1) - torch.roll(img, 1, dims=-1))
    gy = 0.5 * (torch.roll(img, -1, dims=-2) - torch.roll(img, 1, dims=-2))
    return gx, gy


@functools.lru_cache(maxsize=16)
def _linear_taps(n_in: int, n_out: int, device: torch.device):
    """Source taps and weights of OpenCV's INTER_LINEAR along one axis:
    src = (dst + 0.5) * n_in / n_out - 0.5 in float64, cast to float32 as
    OpenCV does, then floor; a tap left of 0 or right of n_in - 1 clamps
    to the edge with weight 0 on its neighbour. Cached per device, so a
    resize of a size seen before copies nothing to the device."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    w1 = (f - i0).astype(np.float32)
    low = i0 < 0
    i0[low], w1[low] = 0, 0.0
    high = i0 >= n_in - 1
    i0[high], w1[high] = n_in - 1, 0.0
    i1 = np.minimum(i0 + 1, n_in - 1)
    return tuple(torch.from_numpy(a).to(device) for a in (i0, i1, 1.0 - w1, w1))


def _resize_bilinear(img: torch.Tensor, size_wh) -> torch.Tensor:
    """`cv2.resize(img, (w, h))` with INTER_LINEAR on float32 (..., H, W):
    rows first, then columns, with float32 weights (OpenCV's order). For an
    exact 2x downscale OpenCV swaps in INTER_AREA, the mean of each 2x2
    block, and so does this."""
    w, h = int(size_wh[0]), int(size_wh[1])
    H, W = img.shape[-2], img.shape[-1]
    if 2 * w == W and 2 * h == H:
        a, b = img[..., 0::2, 0::2], img[..., 0::2, 1::2]
        c, d = img[..., 1::2, 0::2], img[..., 1::2, 1::2]
        return (a + b + c + d) * 0.25
    x0, x1, ax0, ax1 = _linear_taps(W, w, img.device)
    y0, y1, ay0, ay1 = _linear_taps(H, h, img.device)
    rows = img.index_select(-1, x0) * ax0 + img.index_select(-1, x1) * ax1
    return rows.index_select(-2, y0) * ay0[:, None] + rows.index_select(-2, y1) * ay1[:, None]


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Sample img (H, W) at continuous xy (..., 2) = (x, y) pixel coords."""
    H, W = img.shape[-2], img.shape[-1]
    x = xy[..., 0]
    y = xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.long()
    y0i = y0.long()
    flat = img.reshape(-1)

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        lin = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        v = flat.index_select(0, lin.reshape(-1)).reshape(lin.shape)
        return torch.where(inside, v, torch.full_like(v, fill))

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )
