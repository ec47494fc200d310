"""Spherical-harmonic lighting estimation.

Port of `alicevision_tpu/photometric/lighting.py` (ref:
src/aliceVision/lightingEstimation/augmentedNormals.cpp — order-2 SH basis
from normals, lightingEstimation.cpp — per-channel least squares): one
9-coefficient least squares over all masked pixels on their device, its
9x9 normal equations solved in float64.
"""

from __future__ import annotations

import torch

from ..numeric import f32_matmuls


def augmented_normals(normals: torch.Tensor) -> torch.Tensor:
    """Order-2 SH basis evaluated at normals (..., 3) -> (..., 9)."""
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    return torch.stack([torch.ones_like(nx), nx, ny, nz, nx * ny, nx * nz, ny * nz, nx * nx - ny * ny,
                        3.0 * nz * nz - 1.0], dim=-1)


@f32_matmuls
def estimate_sh_lighting(image: torch.Tensor, normals: torch.Tensor, albedo: torch.Tensor | None = None,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Least-squares SH coefficients (9,) or (9, C) of a shading image (H,
    W) or (H, W, C) with normals (H, W, 3): I = albedo * (B(n) @ L)."""
    B = augmented_normals(normals).reshape(-1, 9)
    I = image.reshape(B.shape[0], -1).to(B.dtype)  # noqa: E741
    if albedo is not None:
        B = B * albedo.reshape(-1, 1)
    w = mask.reshape(-1, 1).to(B.dtype) if mask is not None else torch.ones((B.shape[0], 1), dtype=B.dtype,
                                                                             device=B.device)
    # the normal equations formed and solved in float64: a relief's normals
    # span a narrow cone, and B's columns are then near collinear
    B64, Bw64 = B.double(), (B * w).double()
    BtB = Bw64.T @ B64 + 1e-6 * torch.eye(9, dtype=torch.float64, device=B.device)
    return torch.linalg.solve(BtB, Bw64.T @ I.double()).to(B.dtype).squeeze()


def render_sh(normals: torch.Tensor, L: torch.Tensor, albedo=None) -> torch.Tensor:
    """Shade normals with SH coefficients (inverse of the estimator)."""
    s = augmented_normals(normals) @ L
    if albedo is not None:
        s = s * albedo
    return s
