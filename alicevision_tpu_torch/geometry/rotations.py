"""SO(3) primitives: quaternions, rotation matrices, exp/log maps.

Port of `alicevision_tpu/geometry/rotations.py` (ref:
src/aliceVision/geometry/lie.hpp). Pure functions over tensors that batch
over leading dimensions: a "rotation" is either a unit quaternion
``(..., 4)`` stored (w, x, y, z) or a matrix ``(..., 3, 3)``.

float32 throughout — Shepperd's method for mat->quat and Taylor fallbacks
near theta = 0, with the reference's thresholds.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)


def quat_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product (w, x, y, z)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), w >= 0.

    Branch-free Shepperd's method: all four candidate quaternions, and the
    one whose pivot (diagonal combination) is largest is kept — the first
    of equal pivots, as in the reference."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidates, each scaled by 4*q_k^2 (k = w, x, y, z).
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)

    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(pivots, dim=-1)[..., None]
    q = torch.where(best == 0, qw, torch.where(best == 1, qx, torch.where(best == 2, qy, qz)))
    q = quat_normalize(q)
    # Canonical sign: w >= 0.
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> skew-symmetric (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    m = torch.stack([zeros, -wz, wy, wz, zeros, -wx, -wy, wx, zeros], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3): axis-angle (..., 3) -> matrix.

    Rodrigues with a Taylor fallback below theta^2 = 1e-8 (f32-safe)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    # K @ K == w w^T - theta^2 I in closed form (elementwise, exact).
    KK = w[..., :, None] * w[..., None, :] - theta2[..., None, None] * eye
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS))
    return eye + a[..., None, None] * K + b[..., None, None] * KK


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map SO(3) -> so(3), through the quaternion (f32-safe)."""
    q = mat_to_quat(R)
    w = q[..., 0].clamp(-1.0, 1.0)
    v = q[..., 1:]
    vnorm = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vnorm, w)
    scale = torch.where(vnorm < _EPS, 2.0, theta / vnorm.clamp(min=_EPS))
    return v * scale[..., None]


def quat_exp_tangent(q: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """Right-multiply a rotation (as quat) by exp(dw): the retraction of the
    BA manifold (ref: sfm/bundle/manifolds/so3.hpp semantics)."""
    half = 0.5 * dw
    theta2 = torch.sum(half * half, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    w = torch.where(small[..., 0], 1.0 - theta2[..., 0] / 2.0, torch.cos(theta[..., 0]))
    k = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    dq = torch.cat([w[..., None], k * half], dim=-1)
    return quat_normalize(quat_mul(q, dq))


def random_rotation(generator: torch.Generator, shape=(), device=None) -> torch.Tensor:
    """Uniform random rotation matrices via normalized Gaussian quaternions,
    drawn from ``generator`` (its draws differ from jax.random's)."""
    q = torch.randn(tuple(shape) + (4,), generator=generator, device=generator.device)
    return quat_to_mat(quat_normalize(q)).to(device if device is not None else q.device)
