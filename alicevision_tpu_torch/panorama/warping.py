"""Spherical (equirectangular) mapping and per-view warping.

Port of `alicevision_tpu/panorama/warping.py` (ref:
src/aliceVision/panorama/sphericalMapping.cpp, warper.cpp,
remapBbox.cpp). The rotation-only camera model of the panorama pipeline
(ReconstructionEngine_panorama) maps pixels to unit directions; warping a
view into the equirect domain is one inverse map plus the port's
`bilinear_sample`, on the image's device.
"""

from __future__ import annotations

import math

import torch

from ..image.filtering import bilinear_sample

_EPS = 1e-9


def equirect_to_direction(uv: torch.Tensor, pano_wh) -> torch.Tensor:
    """Equirect pixel (..., 2) -> unit direction (..., 3).

    Convention: u in [0, W) -> longitude [-pi, pi), v in [0, H) -> latitude
    [-pi/2, pi/2]; +z is the forward axis at (lon=0, lat=0), +y down.
    """
    W, H = pano_wh
    lon = (uv[..., 0] / W - 0.5) * 2.0 * math.pi
    lat = (uv[..., 1] / H - 0.5) * math.pi
    cl = torch.cos(lat)
    return torch.stack([cl * torch.sin(lon), torch.sin(lat), cl * torch.cos(lon)], dim=-1)


def direction_to_equirect(d: torch.Tensor, pano_wh) -> torch.Tensor:
    W, H = pano_wh
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=_EPS)
    lon = torch.atan2(d[..., 0], d[..., 2])
    lat = torch.asin(torch.clamp(d[..., 1], -1.0, 1.0))
    u = (lon / (2.0 * math.pi) + 0.5) * W
    v = (lat / math.pi + 0.5) * H
    return torch.stack([u, v], dim=-1)


def warp_to_equirect(
    img: torch.Tensor,  # (H, W) or (H, W, C)
    K: torch.Tensor,  # (3, 3)
    R: torch.Tensor,  # (3, 3) world->camera rotation (rotation-only pose)
    pano_wh,
):
    """Warp one view into the full equirect canvas.

    Returns (warped (Hp, Wp[, C]), valid (Hp, Wp)). For each pano pixel:
    direction -> camera frame -> pinhole projection -> bilinear sample.
    """
    W, H = pano_wh
    dev = img.device
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    d_world = equirect_to_direction(torch.stack([gx, gy], -1), pano_wh)
    d_cam = torch.einsum("ij,hwj->hwi", R, d_world)
    z = d_cam[..., 2]
    in_front = z > 1e-6
    zs = torch.where(in_front, z, torch.ones_like(z))
    u = K[0, 0] * d_cam[..., 0] / zs + K[0, 2]
    v = K[1, 1] * d_cam[..., 1] / zs + K[1, 2]

    Hi, Wi = img.shape[:2]
    inside = in_front & (u >= 0) & (u <= Wi - 1) & (v >= 0) & (v <= Hi - 1)
    uv = torch.stack([u, v], -1)
    if img.ndim == 2:
        out = bilinear_sample(img, uv)
    else:
        out = torch.stack([bilinear_sample(img[..., c], uv) for c in range(img.shape[-1])], -1)
    mask = inside if img.ndim == 2 else inside[..., None]
    return torch.where(mask, out, torch.zeros_like(out)), inside
