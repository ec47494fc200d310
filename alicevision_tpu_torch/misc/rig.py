"""Multi-camera rig calibration.

Port of `alicevision_tpu/misc/rig.py`, the counterpart of the reference's
rig module (ref: src/aliceVision/rig/Rig.cpp: the fixed sub-pose of each
camera relative to the rig body from per-frame tracked poses). The pose of
camera k relative to camera 0 is averaged over the frames: rotations by
quaternion eigen-averaging, centres by the mean, a closed-form batched
estimator where the reference refines iteratively.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..geometry import compose, pose_from_Rc, pose_inverse, quat_to_mat
from ..numeric import eigh, f32_matmuls


@f32_matmuls
def average_quaternions(qs: torch.Tensor, weights=None) -> torch.Tensor:
    """Markley quaternion averaging: the principal eigenvector of
    sum w q qᵀ over qs (n, 4), sign-fixed to w >= 0."""
    w = torch.ones(qs.shape[0], dtype=qs.dtype, device=qs.device) if weights is None else weights
    _, V = eigh(torch.einsum("n,ni,nj->ij", w, qs, qs))
    q = V[:, -1]
    return q * torch.sign(q[0] + 1e-12)


def calibrate_rig(poses_per_cam: list, device="cuda") -> list:
    """poses_per_cam[k] = (R (F, 3, 3), c (F, 3)) tracked world->cam poses of
    camera k over F frames. Returns the fixed pose of each camera in
    camera 0's frame (the sub-poses), a list of numpy (R_rel, c_rel)."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    R0, c0 = poses_per_cam[0]
    p0 = pose_from_Rc(t(R0), t(c0))
    out = []
    for Rk, ck in poses_per_cam:
        rel = compose(pose_from_Rc(t(Rk), t(ck)), pose_inverse(p0))  # camera k in camera 0's frame
        q = average_quaternions(rel.q)
        out.append((quat_to_mat(q).cpu().numpy(), torch.mean(rel.c, dim=0).cpu().numpy()))
    return out
