"""SE(3) poses, reference-convention compatible.

Port of `alicevision_tpu/geometry/pose.py`. A pose is (rotation R, center c)
with the world->camera map ``x_cam = R @ (x_world - c)`` (ref:
src/aliceVision/geometry/Pose3.hpp), stored as struct-of-arrays: rotations
``(..., 4)`` unit quaternions (w, x, y, z) and centers ``(..., 3)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .rotations import mat_to_quat, quat_conj, quat_mul, quat_normalize, quat_rotate, quat_to_mat


class Pose(NamedTuple):
    """Batched SE(3): world->camera rotation (quat) + camera center (world)."""

    q: torch.Tensor  # (..., 4) unit quaternion, world->camera
    c: torch.Tensor  # (..., 3) camera center in world frame

    @property
    def R(self) -> torch.Tensor:  # (..., 3, 3)
        return quat_to_mat(self.q)

    @property
    def t(self) -> torch.Tensor:
        """Translation of the [R|t] form: t = -R @ c."""
        return -quat_rotate(self.q, self.c)


def pose_identity(shape=(), dtype=torch.float32, device=None) -> Pose:
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return Pose(q=q, c=torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device))


def pose_from_Rt(R: torch.Tensor, t: torch.Tensor) -> Pose:
    """From the projective [R|t] form (x_cam = R x + t): c = -R^T t."""
    c = -torch.einsum("...ji,...j->...i", R, t)
    return Pose(q=mat_to_quat(R), c=c)


def pose_from_Rc(R: torch.Tensor, c: torch.Tensor) -> Pose:
    return Pose(q=mat_to_quat(R), c=c)


def transform(pose: Pose, x_world: torch.Tensor) -> torch.Tensor:
    """World -> camera: R @ (x - c). Broadcasts over leading dims."""
    return quat_rotate(pose.q, x_world - pose.c)


def inverse_transform(pose: Pose, x_cam: torch.Tensor) -> torch.Tensor:
    """Camera -> world: R^T @ x + c."""
    return quat_rotate(quat_conj(pose.q), x_cam) + pose.c


def compose(a: Pose, b: Pose) -> Pose:
    """(a * b)(x) = a(b(x)): world -> b -> a.

    Matches Pose3::operator* of the reference: R = Ra Rb, c = cb + Rb^T ca."""
    q = quat_normalize(quat_mul(a.q, b.q))
    c = b.c + quat_rotate(quat_conj(b.q), a.c)
    return Pose(q=q, c=c)


def pose_inverse(p: Pose) -> Pose:
    qi = quat_conj(p.q)
    return Pose(q=qi, c=-quat_rotate(p.q, p.c))


def relative_pose(a: Pose, b: Pose) -> Pose:
    """Pose of camera b expressed in camera a's frame: b * a^{-1}."""
    return compose(b, pose_inverse(a))


def projection_matrix(K: torch.Tensor, pose: Pose) -> torch.Tensor:
    """P = K [R | t] with t = -R c. Shapes broadcast: (...,3,3) x Pose."""
    R = pose.R
    t = pose.t[..., :, None]
    return K @ torch.cat([R, t], dim=-1)
