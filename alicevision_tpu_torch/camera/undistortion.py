"""Undistortion models — the pixel-to-pixel lens-grid family (3DE).

Port of `alicevision_tpu/camera/undistortion.py` (ref:
src/aliceVision/camera/Undistortion.hpp:20-155, Undistortion.cpp:12-36,
Undistortion3DEA4.cpp, Undistortion3DEClassicLD.cpp,
Undistortion3DERadial4.cpp, UndistortionRadial.cpp). Undistortion is a
pixel-to-pixel operation independent of focal length: points are centred
on (size/2 + offset), normalized by the half-diagonal, warped by the model
polynomial and de-normalized. The model of an intrinsic is a host int; the
warps are batched over points on the points' device, and the Newton inverse
takes the exact 2x2 Jacobian (`torch.func.jacfwd`) for a fixed number of
iterations (ref: Undistortion3DEA4.cpp:316-334 loops until converged).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device

# Model codes, in the reference's EUNDISTORTION order
# (ref: src/aliceVision/camera/cameraCommon.hpp:33-40).
UNDIST_NONE = 0
UNDIST_RADIALK3 = 1
UNDIST_3DEANAMORPHIC4 = 2
UNDIST_3DECLASSICLD = 3
UNDIST_3DERADIAL4 = 4

UNDIST_PARAMS = 14  # padded parameter slots (3DEA4 uses 13)

# Serialization names (ref: cameraCommon.hpp:188-204 EUNDISTORTION_enumToString).
UNDIST_NAMES = {
    UNDIST_NONE: "none",
    UNDIST_RADIALK3: "radialk3",
    UNDIST_3DEANAMORPHIC4: "3deanamorphic4",
    UNDIST_3DECLASSICLD: "3declassicld",
    UNDIST_3DERADIAL4: "3deradial4",
}
UNDIST_CODES = {v: k for k, v in UNDIST_NAMES.items()}

N_UNDIST_PARAMS = {
    UNDIST_NONE: 0,
    UNDIST_RADIALK3: 3,
    UNDIST_3DEANAMORPHIC4: 13,
    UNDIST_3DECLASSICLD: 5,
    UNDIST_3DERADIAL4: 8,
}


def default_params(kind: int) -> np.ndarray:
    """Neutral (identity) parameters, padded to UNDIST_PARAMS
    (ref: Undistortion3DEA4.hpp:27, Undistortion3DEClassicLD.hpp:27)."""
    d = np.zeros(UNDIST_PARAMS)
    if kind == UNDIST_3DEANAMORPHIC4:
        d[11] = 1.0  # sqx
        d[12] = 1.0  # sqy
    elif kind == UNDIST_3DECLASSICLD:
        d[1] = 1.0  # squeeze (divides x coefficients)
    return d


# ---------------------------------------------------------------------------
# Per-model normalized warps (points (..., 2), params (UNDIST_PARAMS,))
# ---------------------------------------------------------------------------


def _radialk3(params, pa, p):
    """ref: UndistortionRadial.cpp:12-26."""
    k1, k2, k3 = params[0], params[1], params[2]
    r2 = (p * p).sum(-1)
    s = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    return p * s[..., None]


def _a4_base(params, p):
    """The unrotated anamorphic polynomial (ref: Undistortion3DEA4.cpp:32-60),
    with cos(2t), cos(4t) expanded in x, y to stay finite at r = 0."""
    cx02, cy02, cx22, cy22 = params[0], params[1], params[2], params[3]
    cx04, cy04, cx24, cy24 = params[4], params[5], params[6], params[7]
    cx44, cy44 = params[8], params[9]
    x, y = p[..., 0], p[..., 1]
    xx, yy = x * x, y * y
    r2 = xx + yy
    r2c2 = xx - yy  # r2 * cos(2 theta)
    r4 = r2 * r2
    r4c2 = r2 * r2c2  # r4 * cos(2 theta)
    r4c4 = xx * xx - 6.0 * xx * yy + yy * yy  # r4 * cos(4 theta)
    dx = 1.0 + cx02 * r2 + cx04 * r4 + cx22 * r2c2 + cx24 * r4c2 + cx44 * r4c4
    dy = 1.0 + cy02 * r2 + cy04 * r4 + cy22 * r2c2 + cy24 * r4c2 + cy44 * r4c4
    return torch.stack([x * dx, y * dy], dim=-1)


def _anamorphic4(params, pa, p):
    """ref: Undistortion3DEA4.cpp:62-90 (rotate by phi, base warp, squeeze,
    rotate back; x pre-divided by the pixel aspect ratio)."""
    phi, sqx, sqy = params[10], params[11], params[12]
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    xu = p[..., 0] / pa
    yu = p[..., 1]
    rx = cphi * xu - sphi * yu
    ry = sphi * xu + cphi * yu
    b = _a4_base(params, torch.stack([rx, ry], dim=-1))
    sx = b[..., 0] * pa * sqx
    sy = b[..., 1] * sqy
    return torch.stack([cphi * sx + sphi * sy, -sphi * sx + cphi * sy], dim=-1)


def _classicld(params, pa, p):
    """ref: Undistortion3DEClassicLD.cpp:12-45."""
    c2, sq, cx, cy, c4 = params[0], params[1], params[2], params[3], params[4]
    cxx = c2 / sq
    cxy = (c2 + cx) / sq
    cxxx = c4 / sq
    cxxy = 2.0 * c4 / sq
    cxyy = c4 / sq
    cyx = c2 + cy
    cyy = c2
    cyxx = c4
    cyyx = 2.0 * c4
    cyyy = c4
    x, y = p[..., 0], p[..., 1]
    x2, y2 = x * x, y * y
    x4, y4, x2y2 = x2 * x2, y2 * y2, x2 * y2
    nx = x * (1.0 + cxx * x2 + cxy * y2 + cxxx * x4 + cxxy * x2y2 + cxyy * y4)
    ny = y * (1.0 + cyx * x2 + cyy * y2 + cyxx * x4 + cyyx * x2y2 + cyyy * y4)
    return torch.stack([nx, ny], dim=-1)


def _radial4(params, pa, p):
    """ref: Undistortion3DERadial4.cpp:12-56 (radial + de-centering terms,
    then the cylindric-bending shear matrix)."""
    c2, u1, v1, c4, u3, v3 = (params[i] for i in range(6))
    phi, b = params[6], params[7]
    q = torch.sqrt(1.0 + b)
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    m11 = cphi * cphi * q + sphi * sphi / q
    m12 = (q - 1.0 / q) * cphi * sphi
    m22 = cphi * cphi / q + sphi * sphi * q
    x, y = p[..., 0], p[..., 1]
    x2, y2, xy = x * x, y * y, x * y
    r2 = x2 + y2
    r4 = r2 * r2
    s = 1.0 + c2 * r2 + c4 * r4
    rx = x * s + (r2 + 2.0 * x2) * (u1 + u3 * r2) + 2.0 * xy * (v1 + v3 * r2)
    ry = y * s + (r2 + 2.0 * y2) * (v1 + v3 * r2) + 2.0 * xy * (u1 + u3 * r2)
    return torch.stack([m11 * rx + m12 * ry, m12 * rx + m22 * ry], dim=-1)


def _identity(params, pa, p):
    return p


_MODEL_FNS = {
    UNDIST_NONE: _identity,
    UNDIST_RADIALK3: _radialk3,
    UNDIST_3DEANAMORPHIC4: _anamorphic4,
    UNDIST_3DECLASSICLD: _classicld,
    UNDIST_3DERADIAL4: _radial4,
}


def _params_like(params, p: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(params, dtype=p.dtype, device=p.device)


def undistort_normalized(kind: int, params, pa, p: torch.Tensor) -> torch.Tensor:
    """The model warp in normalized coordinates; `kind` is a host int."""
    return _MODEL_FNS[int(kind)](_params_like(params, p), float(pa), p)


def inverse_normalized(kind: int, params, pa, p: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """Newton inverse: q such that undistort(q) = p, a fixed number of
    steps from q = p with the exact 2x2 Jacobian (its determinant floored at
    1e-24, as the JAX package does)."""
    kind = int(kind)
    if kind == UNDIST_NONE:
        return p
    params = _params_like(params, p)
    pa = float(pa)

    def point_fn(q):
        return _MODEL_FNS[kind](params, pa, q)

    jac = torch.func.vmap(torch.func.jacfwd(point_fn))
    target = p.reshape(-1, 2)
    q = target
    for _ in range(iters):
        f = point_fn(q) - target
        J = jac(q)
        det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        det = torch.where(det.abs() < 1e-24, torch.full_like(det, 1e-24), det)
        dx = (J[:, 1, 1] * f[:, 0] - J[:, 0, 1] * f[:, 1]) / det
        dy = (-J[:, 1, 0] * f[:, 0] + J[:, 0, 0] * f[:, 1]) / det
        q = q - torch.stack([dx, dy], dim=-1)
    return q.reshape(p.shape)


# ---------------------------------------------------------------------------
# Pixel-space wrappers (the Undistortion base-class contract)
# ---------------------------------------------------------------------------


class Undistortion(NamedTuple):
    """One intrinsic's undistortion state, on the host
    (ref: Undistortion.hpp:147-154 protected members)."""

    kind: int
    params: np.ndarray  # (UNDIST_PARAMS,)
    size: np.ndarray  # (2,) w, h
    offset: np.ndarray  # (2,)
    pixel_aspect_ratio: float = 1.0
    is_desqueezed: bool = False
    diagonal: float = 0.0  # 0 -> computed from size

    @staticmethod
    def make(kind: int, w: int, h: int, params=None, offset=(0.0, 0.0),
             pixel_aspect_ratio: float = 1.0, is_desqueezed: bool = False,
             diagonal: float = 0.0) -> "Undistortion":
        d = default_params(kind)
        if params is not None:
            params = np.asarray(params, np.float64)
            d[: len(params)] = params
        return Undistortion(int(kind), d, np.array([w, h], np.float64), np.asarray(offset, np.float64),
                            float(pixel_aspect_ratio), bool(is_desqueezed), float(diagonal))

    def half_diagonal(self) -> float:
        """ref: Undistortion.hpp:68-79 setSize (y compressed by the pixel
        aspect ratio unless the plate is already desqueezed)."""
        if self.diagonal > 0:
            return float(self.diagonal)
        w, h = float(self.size[0]), float(self.size[1])
        hh = h if self.is_desqueezed else h / self.pixel_aspect_ratio
        return 0.5 * float(np.hypot(w, hh))


def _norm_consts(u: Undistortion, pix: torch.Tensor):
    diag = u.half_diagonal()
    pa = 1.0 if u.is_desqueezed else u.pixel_aspect_ratio
    center = 0.5 * np.asarray(u.size, np.float64) + np.asarray(u.offset, np.float64)
    norm = torch.tensor([diag, pa * diag], dtype=pix.dtype, device=pix.device)
    return norm, torch.as_tensor(center, dtype=pix.dtype, device=pix.device)


def _pixels(pix, device) -> torch.Tensor:
    if isinstance(pix, torch.Tensor):
        return pix if pix.is_floating_point() else pix.float()
    return torch.as_tensor(np.asarray(pix), dtype=torch.float32, device=resolve_device(device))


def undistort_pixels(u: Undistortion, pix, device="cuda") -> torch.Tensor:
    """Pixel -> undistorted pixel (ref: Undistortion.cpp:12-36), on pix's
    device (a tensor) or on `device` (host points, as float32)."""
    pix = _pixels(pix, device)
    norm, center = _norm_consts(u, pix)
    out = undistort_normalized(u.kind, u.params, u.pixel_aspect_ratio, (pix - center) / norm)
    return out * norm + center


def inverse_pixels(u: Undistortion, pix, iters: int = 20, device="cuda") -> torch.Tensor:
    """Undistorted pixel -> distorted pixel (adds the lens distortion back,
    the Newton inverse), on pix's device or on `device`."""
    pix = _pixels(pix, device)
    norm, center = _norm_consts(u, pix)
    out = inverse_normalized(u.kind, u.params, u.pixel_aspect_ratio, (pix - center) / norm, iters)
    return out * norm + center


def undistort_image(u: Undistortion, img: torch.Tensor, out_hw=None) -> torch.Tensor:
    """Resample an image (H, W) or (H, W, C) on its device so lens
    distortion is removed: each output pixel p samples the plate at
    inverse(p) (ref: camera/Undistortion.hpp:137)."""
    from ..image.filtering import bilinear_sample

    h, w = (img.shape[0], img.shape[1]) if out_hw is None else out_hw
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                            torch.arange(w, dtype=torch.float32, device=img.device), indexing="ij")
    grid = torch.stack([xx, yy], dim=-1).reshape(-1, 2)
    src = inverse_pixels(u, grid).reshape(h, w, 2).to(img.dtype)
    if img.ndim == 3:  # (H, W, C): each channel plane
        return torch.stack([bilinear_sample(img[..., c], src) for c in range(img.shape[-1])], dim=-1)
    return bilinear_sample(img, src)


# ---------------------------------------------------------------------------
# Scene integration (SfMData.intrinsic_extra round-trip dict)
# ---------------------------------------------------------------------------

_EXTRA_KEY = "undistortion"


def to_extra(u: Undistortion) -> dict:
    return {
        "type": UNDIST_NAMES[u.kind],
        "params": [float(x) for x in u.params[: N_UNDIST_PARAMS[u.kind]]],
        "offset": [float(u.offset[0]), float(u.offset[1])],
        "pixelAspectRatio": float(u.pixel_aspect_ratio),
        "isDesqueezed": bool(u.is_desqueezed),
        "diagonal": float(u.half_diagonal()),
    }


def from_extra(extra: dict, w: int, h: int):
    d = extra.get(_EXTRA_KEY)
    if not d or d.get("type", "none") == "none":
        return None
    return Undistortion.make(UNDIST_CODES[d["type"]], w, h, d.get("params"), tuple(d.get("offset", (0.0, 0.0))),
                             float(d.get("pixelAspectRatio", 1.0)), bool(d.get("isDesqueezed", False)),
                             float(d.get("diagonal", 0.0)))


def scene_undistortion(scene, intrinsic_idx: int):
    """The Undistortion of one intrinsic, or None."""
    w, h = int(scene.sizes[intrinsic_idx, 0]), int(scene.sizes[intrinsic_idx, 1])
    return from_extra(scene.intrinsic_extra[intrinsic_idx], w, h)


def set_scene_undistortion(scene, intrinsic_idx: int, u: Undistortion) -> None:
    scene.intrinsic_extra[intrinsic_idx][_EXTRA_KEY] = to_extra(u)
