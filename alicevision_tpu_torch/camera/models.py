"""Camera intrinsic models — vectorized and branchless.

Port of `alicevision_tpu/camera/models.py`: model codes and names, the
`Intrinsics` table, the branchless radial/Brown distortion and its
fixed-count inverse, the pixel <-> normalized-plane maps, the pinhole and
equidistant projections and the back-projected rays. Conventions are the
reference's, so .sfm files interoperate:
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


def make_intrinsics(
    w,
    h,
    focal_px,
    cam_kind=CAM_PINHOLE,
    disto_kind=DISTO_NONE,
    disto_params=(),
    offset=(0.0, 0.0),
    focal_y_px=None,
    device=None,
) -> Intrinsics:
    """Build a single (unbatched) intrinsic row."""
    fy = focal_px if focal_y_px is None else focal_y_px
    d = torch.zeros((DISTO_PARAMS,), dtype=torch.float32)
    if len(disto_params):
        d[: len(disto_params)] = torch.as_tensor(disto_params, dtype=torch.float32)
    return Intrinsics(
        cam_kind=torch.tensor(cam_kind, dtype=torch.int32, device=device),
        disto_kind=torch.tensor(disto_kind, dtype=torch.int32, device=device),
        scale=torch.tensor([focal_px, fy], dtype=torch.float32, device=device),
        offset=torch.tensor(offset, dtype=torch.float32, device=device),
        size=torch.tensor([w, h], dtype=torch.float32, device=device),
        disto=d.to(device),
    )


def stack_intrinsics(rows) -> Intrinsics:
    """Stack unbatched rows into a batched (I,) table."""
    return Intrinsics(*(torch.stack(xs) for xs in zip(*rows)))


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


def remove_distortion(
    kind: torch.Tensor, d: torch.Tensor, p: torch.Tensor, iters: int = 12
) -> torch.Tensor:
    """Invert add_distortion with a fixed count of fixed-point steps
    q <- q - (disto(q) - p), as the reference package does (the C++
    reference bisects on the radius, camera/DistortionRadial.hpp:26-46)."""
    q = p
    for _ in range(iters):
        q = q - (add_distortion(kind, d, q) - p)
    return q


def cam2ima(intr: Intrinsics, p: torch.Tensor) -> torch.Tensor:
    return p * intr.scale + intr.principal_point


def ima2cam(intr: Intrinsics, pix: torch.Tensor) -> torch.Tensor:
    return (pix - intr.principal_point) / intr.scale


def project_cam(intr: Intrinsics, x_cam: torch.Tensor, apply_distortion: bool = True) -> torch.Tensor:
    """Project camera-frame 3D points (..., 3) to pixels (..., 2).

    Pinhole: perspective divide then distortion (camera/Pinhole.cpp).
    Equidistant: r = f * theta (camera/Equidistant.cpp:15-40), with scale(0)
    as f in pixels. Both are computed and one is kept by `torch.where`."""
    z = x_cam[..., 2]
    z_safe = torch.where(torch.abs(z) < _EPS, torch.full_like(z, _EPS), z)
    p_pin = x_cam[..., :2] / z_safe[..., None]

    # Equidistant: radius proportional to the angle from the optical axis.
    rho = torch.linalg.norm(x_cam[..., :2], dim=-1)
    angle_z = torch.atan2(rho, z)
    rho_safe = torch.clamp(rho, min=_EPS)
    p_equi = x_cam[..., :2] / rho_safe[..., None] * angle_z[..., None]

    p = torch.where((intr.cam_kind == CAM_EQUIDISTANT)[..., None], p_equi, p_pin)
    if apply_distortion:
        p = add_distortion(intr.disto_kind, intr.disto, p)
    return cam2ima(intr, p)


def _radial_scale_and_slope(kind, d, r2):
    """_radial_scale's s(r2) and its derivative ds/dr2, per model."""
    k1, k2, k3, k4 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    s_k1 = 1.0 + k1 * r2
    s_k3 = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    ds_k3 = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)

    r = torch.sqrt(torch.clamp(r2, min=_EPS))
    dr = torch.where(r2 > _EPS, 0.5 / r, torch.zeros_like(r))  # dr/dr2
    theta = torch.atan(r)
    t2 = theta * theta
    theta_dist = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    dtd = (1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3 + t2 * 9.0 * k4)))) / (1.0 + r * r)
    s_fish = theta_dist / r
    ds_fish = (dtd * r - theta_dist) / (r * r) * dr

    k1s = torch.where(torch.abs(k1) < 1e-6, torch.full_like(k1, 1e-6), k1)
    w = 2.0 * torch.tan(0.5 * k1s)
    a = torch.atan(w * r)
    s_f1 = a / (k1s * r)
    ds_f1 = (w * r / (1.0 + (w * r) ** 2) - a) / (k1s * r * r) * dr
    tiny = torch.abs(k1 * r) < 1e-8
    s_f1 = torch.where(tiny, torch.ones_like(s_f1), s_f1)
    ds_f1 = torch.where(tiny, torch.zeros_like(ds_f1), ds_f1)

    def pick(v_k1, v_k3, v_fish, v_f1, v_none):
        return torch.where(
            kind == DISTO_RADIALK1, v_k1,
            torch.where(kind == DISTO_RADIALK3, v_k3,
                        torch.where(kind == DISTO_FISHEYE, v_fish,
                                    torch.where(kind == DISTO_FISHEYE1, v_f1, v_none))),
        )

    one, zero = torch.ones_like(r2), torch.zeros_like(r2)
    return pick(s_k1, s_k3, s_fish, s_f1, one), pick(k1 + zero, ds_k3, ds_fish, ds_f1, zero)


def _distortion_jacobian(kind, d, p):
    """d add_distortion / d p as four (...,) components (j00, j01, j10, j11)."""
    x, y = p[..., 0], p[..., 1]
    r2 = torch.sum(p * p, dim=-1)
    s, ds = _radial_scale_and_slope(kind, d, r2)
    rad = (s + 2.0 * x * x * ds, 2.0 * x * y * ds, 2.0 * x * y * ds, s + 2.0 * y * y * ds)

    k1, k2, k3, t1, t2 = (d[..., i] for i in range(5))
    s_rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    ds_rad = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)
    brown = (
        s_rad + 2.0 * x * x * ds_rad + 6.0 * t1 * x + 2.0 * t2 * y,
        2.0 * x * y * ds_rad + 2.0 * t1 * y + 2.0 * t2 * x,
        2.0 * x * y * ds_rad + 2.0 * t2 * x + 2.0 * t1 * y,
        s_rad + 2.0 * y * y * ds_rad + 6.0 * t2 * y + 2.0 * t1 * x,
    )
    is_brown = kind == DISTO_BROWN
    return tuple(torch.where(is_brown, b, a) for a, b in zip(rad, brown))


def project_cam_jacobian(intr: Intrinsics, x_cam: torch.Tensor):
    """`project_cam` (with distortion) and its derivative in closed form:
    returns (pix (..., 2), J (..., 2, 3)) with J[..., r, i] = d pix_r / d x_i;
    pix is project_cam's own result.

    A port addition: the bundle adjuster needs these three columns for
    every observation, and forward-mode autodiff (`torch.func.jvp`) costs
    about 15 ms of host time per call however small the batch."""
    xx, yy, z = x_cam[..., 0], x_cam[..., 1], x_cam[..., 2]
    big = torch.abs(z) >= _EPS
    z_safe = torch.where(big, z, torch.full_like(z, _EPS))
    iz = 1.0 / z_safe
    dz = torch.where(big, -iz * iz, torch.zeros_like(z))  # d(1/z_safe)/dz
    zero = torch.zeros_like(z)
    pin = (xx * iz, yy * iz)
    J_pin = ((iz, zero, xx * dz), (zero, iz, yy * dz))

    rho = torch.linalg.norm(x_cam[..., :2], dim=-1)
    a = torch.atan2(rho, z)
    rho_safe = torch.clamp(rho, min=_EPS)
    f = a / rho_safe
    q = rho * rho + z * z
    q = torch.where(q > 0, q, torch.ones_like(q))
    da_drho, da_dz = z / q, -rho / q
    df_drho = torch.where(rho > _EPS, (da_drho * rho - a) / (rho_safe * rho_safe), da_drho / _EPS)
    ux, uy = xx / rho_safe, yy / rho_safe  # d rho / d (x, y)
    equi = (xx * f, yy * f)
    J_equi = (
        (f + xx * df_drho * ux, xx * df_drho * uy, xx * da_dz / rho_safe),
        (yy * df_drho * ux, f + yy * df_drho * uy, yy * da_dz / rho_safe),
    )

    is_equi = intr.cam_kind == CAM_EQUIDISTANT
    p = torch.stack([torch.where(is_equi, e, q_) for e, q_ in zip(equi, pin)], dim=-1)
    Jp = [[torch.where(is_equi, e, q_) for e, q_ in zip(re, rq)] for re, rq in zip(J_equi, J_pin)]
    d00, d01, d10, d11 = _distortion_jacobian(intr.disto_kind, intr.disto, p)
    fx, fy = intr.scale[..., 0], intr.scale[..., 1]
    J = torch.stack(
        [
            torch.stack([fx * (d00 * Jp[0][i] + d01 * Jp[1][i]) for i in range(3)], dim=-1),
            torch.stack([fy * (d10 * Jp[0][i] + d11 * Jp[1][i]) for i in range(3)], dim=-1),
        ],
        dim=-2,
    )
    return project_cam(intr, x_cam), J


def backproject_ray(intr: Intrinsics, pix: torch.Tensor, remove_disto: bool = True) -> torch.Tensor:
    """Pixel (..., 2) -> unit ray (..., 3) in the camera frame."""
    p = ima2cam(intr, pix)
    if remove_disto:
        p = remove_distortion(intr.disto_kind, intr.disto, p)

    ray_pin = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)

    theta = torch.linalg.norm(p, dim=-1)
    theta_safe = torch.clamp(theta, min=_EPS)
    dir_xy = p / theta_safe[..., None] * torch.sin(theta)[..., None]
    ray_equi = torch.cat([dir_xy, torch.cos(theta)[..., None]], dim=-1)

    ray = torch.where((intr.cam_kind == CAM_EQUIDISTANT)[..., None], ray_equi, ray_pin)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True).clamp(min=_EPS)


def K_matrix(intr: Intrinsics) -> torch.Tensor:
    """Calibration matrix (..., 3, 3) for the pinhole family."""
    fx, fy = intr.scale[..., 0], intr.scale[..., 1]
    pp = intr.principal_point
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    K = torch.stack([fx, zeros, pp[..., 0], zeros, fy, pp[..., 1], zeros, zeros, ones], dim=-1)
    return K.reshape(fx.shape + (3, 3))
