"""Camera intrinsic models — the part the dense path needs.

Port of `alicevision_tpu/camera/models.py` (model codes and names, the
`Intrinsics` table, the branchless radial/Brown distortion and the
pixel <-> normalized-plane maps). Conventions are the reference's, so .sfm
files interoperate:
  * normalized camera coords p = ((u,v) - principal_point) / (fx, fy)
  * principal_point = offset + image_size / 2
  * distortion acts on normalized coords: pix = scale * disto(p) + pp

Distortion parameter slots (padded to DISTO_PARAMS = 6):
  RADIALK1  [k1]
  RADIALK3  [k1, k2, k3]                     x_d = x_u (1 + k1 r^2 + k2 r^4 + k3 r^6)
  BROWN     [k1, k2, k3, t1, t2]             radial + tangential
  FISHEYE   [k1, k2, k3, k4]                 theta-polynomial (OpenCV-style)
  FISHEYE1  [k1]                             atan model
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Distortion model codes.
DISTO_NONE = 0
DISTO_RADIALK1 = 1
DISTO_RADIALK3 = 2
DISTO_BROWN = 3
DISTO_FISHEYE = 4
DISTO_FISHEYE1 = 5

# Camera (projection) model codes.
CAM_PINHOLE = 0
CAM_EQUIDISTANT = 1

DISTO_PARAMS = 6  # padded distortion-parameter slots

_EPS = 1e-12

# Serialization names (ref: camera/cameraCommon.hpp EDISTORTION/EINTRINSIC).
DISTO_NAMES = {
    DISTO_NONE: "none",
    DISTO_RADIALK1: "radialk1",
    DISTO_RADIALK3: "radialk3",
    DISTO_BROWN: "brown",
    DISTO_FISHEYE: "fisheye4",
    DISTO_FISHEYE1: "fisheye1",
}
DISTO_CODES = {v: k for k, v in DISTO_NAMES.items()}
CAM_NAMES = {CAM_PINHOLE: "pinhole", CAM_EQUIDISTANT: "equidistant"}
CAM_CODES = {v: k for k, v in CAM_NAMES.items()}


class Intrinsics(NamedTuple):
    """SoA table of camera intrinsics, one row per intrinsic group.

    All fields are tensors with leading shape (...,) broadcastable against
    point batches."""

    cam_kind: torch.Tensor  # (...,) int32 — CAM_* code
    disto_kind: torch.Tensor  # (...,) int32 — DISTO_* code
    scale: torch.Tensor  # (..., 2) fx, fy in pixels
    offset: torch.Tensor  # (..., 2) principal point offset from image center
    size: torch.Tensor  # (..., 2) float (w, h) in pixels
    disto: torch.Tensor  # (..., DISTO_PARAMS)

    @property
    def principal_point(self) -> torch.Tensor:
        return self.offset + 0.5 * self.size

    def row(self, i: int) -> "Intrinsics":
        """One intrinsic group of a batched table."""
        return Intrinsics(*(x[i] for x in self))


def _radial_scale(kind: torch.Tensor, d: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Isotropic radial scale factor s(r2) for the purely-radial models."""
    k1, k2, k3 = d[..., 0], d[..., 1], d[..., 2]
    s_k1 = 1.0 + k1 * r2
    s_k3 = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))

    r = torch.sqrt(torch.clamp(r2, min=_EPS))
    # FISHEYE: theta-polynomial of atan(r), coef = theta_dist / r.
    theta = torch.atan(r)
    t2 = theta * theta
    theta_dist = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * d[..., 3]))))
    s_fish = theta_dist / r
    # FISHEYE1: coef = atan(2 r tan(k1/2)) / k1 / r  (guard k1*r ~ 0).
    k1s = torch.where(torch.abs(k1) < 1e-6, torch.full_like(k1, 1e-6), k1)
    s_f1 = torch.atan(2.0 * r * torch.tan(0.5 * k1s)) / (k1s * r)
    s_f1 = torch.where(torch.abs(k1 * r) < 1e-8, torch.ones_like(s_f1), s_f1)

    return torch.where(
        kind == DISTO_RADIALK1,
        s_k1,
        torch.where(
            kind == DISTO_RADIALK3,
            s_k3,
            torch.where(
                kind == DISTO_FISHEYE,
                s_fish,
                torch.where(kind == DISTO_FISHEYE1, s_f1, torch.ones_like(r2)),
            ),
        ),
    )


def add_distortion(kind: torch.Tensor, d: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Distort normalized coords p (..., 2). Branchless over model kinds."""
    r2 = torch.sum(p * p, dim=-1)
    s = _radial_scale(kind, d, r2)
    out = p * s[..., None]

    # BROWN adds tangential terms on top of the k1..k3 radial polynomial
    # (ref: camera/DistortionBrown.cpp:14-33).
    k1, k2, k3, t1, t2 = (d[..., i] for i in range(5))
    s_rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    x, y = p[..., 0], p[..., 1]
    dx = t1 * (r2 + 2.0 * x * x) + 2.0 * t2 * x * y
    dy = t2 * (r2 + 2.0 * y * y) + 2.0 * t1 * x * y
    brown = torch.stack([x * s_rad + dx, y * s_rad + dy], dim=-1)

    return torch.where((kind == DISTO_BROWN)[..., None], brown, out)


def cam2ima(intr: Intrinsics, p: torch.Tensor) -> torch.Tensor:
    return p * intr.scale + intr.principal_point


def ima2cam(intr: Intrinsics, pix: torch.Tensor) -> torch.Tensor:
    return (pix - intr.principal_point) / intr.scale
