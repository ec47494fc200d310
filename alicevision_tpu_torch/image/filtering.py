"""Image filtering primitives: separable Gaussian blur and bilinear sampling.

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
