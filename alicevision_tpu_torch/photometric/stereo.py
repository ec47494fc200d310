"""Photometric stereo + normal integration.

Port of `alicevision_tpu/photometric/stereo.py` (ref:
src/aliceVision/photometricStereo/photometricStereo.cpp calibrated solve,
normalIntegration.cpp Poisson integration). The per-pixel normal/albedo
least squares is one 3x3 system shared by every pixel (its inverse taken in
float64), applied over the image on its device; the integration is
matrix-free conjugate gradients on the device, a fixed number of steps with
the reference's stopping rule applied as a mask (no host sync a step).
"""

from __future__ import annotations

import torch

from ..numeric import f32_matmuls


@f32_matmuls
def photometric_stereo(images: torch.Tensor, light_dirs: torch.Tensor, light_intensities: torch.Tensor | None = None,
                       mask: torch.Tensor | None = None):
    """Calibrated PS: I = rho * max(0, n . l). images (L, H, W) under L
    known lights light_dirs (L, 3) (unit, towards the light), on one
    device. Returns (normals (H, W, 3), albedo (H, W)), solved in closed form
    through the 3x3 normal equations (their inverse in float64)."""
    if light_intensities is not None:
        images = images / light_intensities[:, None, None].clamp(min=1e-6)
    Ld = light_dirs.to(images.dtype)
    LtL = Ld.T @ Ld
    inv = torch.linalg.inv((LtL + 1e-9 * torch.eye(3, dtype=LtL.dtype, device=LtL.device)).double()).to(LtL.dtype)
    LtI = torch.einsum("li,lhw->ihw", Ld, images)
    G = torch.einsum("ij,jhw->ihw", inv, LtI).permute(1, 2, 0)  # (H, W, 3)
    albedo = torch.linalg.norm(G, dim=-1)
    normals = G / albedo[..., None].clamp(min=1e-9)
    if mask is not None:
        normals = torch.where(mask[..., None], normals, torch.zeros_like(normals))
        albedo = torch.where(mask, albedo, torch.zeros_like(albedo))
    return normals, albedo


def _zero_last(r: torch.Tensor, dim: int) -> torch.Tensor:
    keep = torch.ones(r.shape[dim], dtype=r.dtype, device=r.device)
    keep[-1] = 0.0
    return r * (keep if dim == 1 else keep[:, None])


def _zero_first(r: torch.Tensor, dim: int) -> torch.Tensor:
    keep = torch.ones(r.shape[dim], dtype=r.dtype, device=r.device)
    keep[0] = 0.0
    return r * (keep if dim == 1 else keep[:, None])


def normal_integration_dct(normals: torch.Tensor, cg_iters: int = 400, tol: float = 1e-8) -> torch.Tensor:
    """Depth from normals (H, W, 3) by least-squares gradient integration
    (normalIntegration.cpp's Poisson path): minimizes ||grad z - (p, q)||²
    with forward differences, the normal equations solved by conjugate
    gradients from z = 0 for at most cg_iters steps, each step taken while
    |r|² > tol² |b|² (the JAX package's `jax.scipy.sparse.linalg.cg`).
    The boundary flux of a non-periodic field is kept, unlike the cosine-
    transform shortcut."""
    nz = normals[..., 2]
    nz = torch.where(nz.abs() < 1e-6, torch.full_like(nz, 1e-6), nz)
    p = -normals[..., 0] / nz
    q = -normals[..., 1] / nz

    def gx(z):  # forward difference, zero on the last column
        return _zero_last(torch.roll(z, -1, 1) - z, 1)

    def gy(z):
        return _zero_last(torch.roll(z, -1, 0) - z, 0)

    def gxT(r):  # adjoint of gx
        r = _zero_last(r, 1)
        return _zero_first(torch.roll(r, 1, 1), 1) - r

    def gyT(r):
        r = _zero_last(r, 0)
        return _zero_first(torch.roll(r, 1, 0), 0) - r

    def A(z):
        # + a tiny Tikhonov term pins the free constant (gauge) for CG
        return gxT(gx(z)) + gyT(gy(z)) + 1e-6 * z

    b = gxT(_zero_last(p, 1)) + gyT(_zero_last(q, 0))
    atol2 = tol * tol * (b * b).sum()
    x = torch.zeros_like(b)
    r = b - A(x)
    d = r
    gamma = (r * r).sum()
    for _ in range(cg_iters):
        active = gamma > atol2
        Ad = A(d)
        alpha = gamma / (d * Ad).sum()
        x_ = x + alpha * d
        r_ = r - alpha * Ad
        gamma_ = (r_ * r_).sum()
        d_ = r_ + (gamma_ / gamma) * d
        x, r, d = torch.where(active, x_, x), torch.where(active, r_, r), torch.where(active, d_, d)
        gamma = torch.where(active, gamma_, gamma)
    return x - x.mean()
