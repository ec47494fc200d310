"""Pure-rotation SfM (nodal / panorama reconstruction).

Port of `alicevision_tpu/sfm/rotation_sfm.py` (ref:
src/aliceVision/sfm/pipeline/panorama/ReconstructionEngine_panorama.cpp,
multiview/relativePose/Rotation3PSolver.hpp used by
src/software/pipeline/main_nodalSfM.cpp:55-64). Relative rotations come
from batched 2-point Kabsch hypotheses on bearing vectors with a-contrario
selection on angular residuals; global rotations from the L2-chordal
averaging of `sfm/global_sfm.py`. The hypotheses' sample indices are drawn
from a `torch.Generator` (the reference package draws from `jax.random`),
or given.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..numeric import f32_matmuls, svd
from ..robust.ransac import acransac_select, logalpha0_point, sample_minimal
from .global_sfm import rotation_averaging_l2


def _kabsch_rotation_only(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Rotation-only Kabsch on unit bearings (no translation/centroid)."""
    w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device) if mask is None else mask.to(src.dtype)
    H = torch.einsum("...ni,...nj->...ij", dst * w[..., None], src)
    U, _, Vt = svd(H)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return U @ (D[..., :, None] * Vt)


def _tan_sq(R: torch.Tensor, b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """tan(angle between R b1 and b2)^2 a correspondence, for one (3, 3) or
    a (H, 3, 3) batch of rotations."""
    cosang = torch.clamp(torch.einsum("...ij,nj,ni->...n", R, b1, b2), -1.0, 1.0)
    return torch.tan(torch.arccos(cosang)) ** 2


@f32_matmuls
def robust_rotation(
    generator: torch.Generator | None,
    b1: torch.Tensor,  # (N, 3) unit bearings in view 1
    b2: torch.Tensor,  # (N, 3) unit bearings in view 2 (same scene points)
    focal_px: float,
    im_size: tuple[float, float],
    valid: torch.Tensor | None = None,
    n_hyps: int = 128,
    max_error_px: float = 4.0,
    idx: torch.Tensor | None = None,
):
    """Relative rotation R with b2 ~ R b1, AC-RANSAC on angular residuals.

    Residuals are measured as tan(angle) ~ normalized-plane displacement so
    the NFA alpha0 of the point model applies unchanged. idx (n_hyps, 2):
    sample indices to use instead of drawing them from `generator`.
    """
    if idx is None:
        idx = sample_minimal(generator, b1.shape[0], 2, n_hyps, valid, device=b1.device)
    idx = idx.to(torch.int64)
    R_h = _kabsch_rotation_only(b1[idx], b2[idx])  # (H, 3, 3)
    res_sq = _tan_sq(R_h, b1, b2)  # (H, N)

    w, h = im_size
    sel = acransac_select(
        res_sq,
        sample_size=2,
        logalpha0=logalpha0_point(w / focal_px, h / focal_px),
        mult_error=1.0,
        valid=valid,
        max_threshold_sq=(max_error_px / focal_px) ** 2,
    )
    # Refit on inliers.
    R_best = _kabsch_rotation_only(b1, b2, mask=sel.inliers)
    v = torch.ones_like(sel.inliers) if valid is None else valid
    inl = (_tan_sq(R_best, b1, b2) <= sel.threshold_sq) & v
    better = torch.sum(inl) >= sel.n_inliers
    R_out = torch.where(better, R_best, R_h[sel.best_hyp])
    inl_out = torch.where(better, inl, sel.inliers)
    return R_out, inl_out, sel


class RotationSfM:
    """Nodal reconstruction: pairwise rotations -> global rotations, on
    `device`."""

    def __init__(self, n_views: int, focal_px: float, im_size, device="cuda"):
        self.n_views = n_views
        self.focal = focal_px
        self.im_size = im_size
        self.device = resolve_device(device)

    def run(self, generator: torch.Generator | None, pair_bearings: dict, irls_iters: int = 2,
            idx: dict | None = None):
        """pair_bearings: {(i, j): (b_i (N,3), b_j (N,3))} matched bearings;
        idx: {(i, j): (128, 2) sample indices} in place of drawing them.

        Returns (R (V, 3, 3) world->cam global rotations, per-pair inlier
        counts), both on the host."""
        edges, R_rel, n_inl = [], [], []
        for (i, j), (bi, bj) in pair_bearings.items():
            t = dict(dtype=torch.float32, device=self.device)
            pidx = None if idx is None else torch.as_tensor(np.asarray(idx[(i, j)]), device=self.device)
            R, inl, _ = robust_rotation(generator, torch.as_tensor(bi, **t), torch.as_tensor(bj, **t), self.focal,
                                        self.im_size, idx=pidx)
            edges.append((i, j))
            R_rel.append(R)
            n_inl.append(torch.sum(inl))
        counts = dict(zip(edges, torch.stack(n_inl).tolist())) if edges else {}
        R = rotation_averaging_l2(self.n_views, np.array(edges), torch.stack(R_rel), irls_iters=irls_iters)
        return R.cpu().numpy(), counts


@f32_matmuls
def refine_rotations_with_constraints(
    R_init,  # (V, 3, 3) world->cam global rotations
    rotation_priors: list,  # dicts {view_i, view_j, R_j_i}
    constraints2d: list,  # dicts {view_i, uv_i, view_j, uv_j}
    intr=None,  # batched Intrinsics (for bearing computation)
    view_intrinsic=None,  # (V,) int
    iters: int = 10,
    prior_weight: float = 1.0,
    constraint_weight: float = 1.0,
    fix_first: bool = True,
    device="cuda",
):
    """Gauss-Newton refinement of global rotations against the scene-model
    constraints (ref: the panorama/nodal engines consume
    SfMData::rotationpriors and ::constraints2d,
    ReconstructionEngine_panorama.cpp / sfmData/SfMData.hpp:60-68), on
    `device`.

    Residuals:
      * priors: so3_log(R_j R_i^T (R_j_i)^T) — 3 per prior;
      * constraints2d: cross-product of the two rays rotated to world,
        ||R_i^T b_i x R_j^T b_j|| — a pure-rotation epipolar alignment.
    The Jacobian is `torch.func.jacfwd` of the residuals; a step is kept
    only if it lowers the squared residual (read back once an iteration).
    Returns the refined (V, 3, 3) rotations as numpy.
    """
    from .. import camera as cam_mod
    from ..geometry.rotations import so3_exp, so3_log

    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    V = len(R_init)
    R0 = torch.as_tensor(np.asarray(R_init), **f32)

    def ids(rows, key):
        return torch.as_tensor([r[key] for r in rows], dtype=torch.int64, device=dev)

    pi, pj = ids(rotation_priors, "view_i"), ids(rotation_priors, "view_j")
    pR = torch.as_tensor(
        np.stack([np.asarray(p["R_j_i"]) for p in rotation_priors]) if rotation_priors else np.zeros((0, 3, 3)),
        **f32,
    )
    table = None if intr is None else cam_mod.Intrinsics(*(torch.as_tensor(x, device=dev) for x in intr))

    def bearing(view, uv):
        uv = torch.as_tensor(np.asarray(uv), **f32)
        if table is None:
            b = torch.cat([uv, torch.ones(1, **f32)], 0)
        else:
            row = table.row(int(view_intrinsic[view]) if view_intrinsic is not None else 0)
            p = cam_mod.remove_distortion(row.disto_kind, row.disto, cam_mod.ima2cam(row, uv))
            b = torch.cat([p, torch.ones(1, **f32)], 0)
        return b / torch.linalg.norm(b)

    ci, cj = ids(constraints2d, "view_i"), ids(constraints2d, "view_j")
    if constraints2d:
        bi = torch.stack([bearing(c["view_i"], c["uv_i"]) for c in constraints2d])
        bj = torch.stack([bearing(c["view_j"], c["uv_j"]) for c in constraints2d])

    live = torch.ones((V, 1), **f32)
    if fix_first:
        live[0] = 0.0

    def residuals(w):  # w: (V, 3) tangents
        R = so3_exp(w * live) @ R0
        res = []
        if len(rotation_priors):
            E = R[pj] @ R[pi].transpose(-1, -2) @ pR.transpose(-1, -2)
            res.append(prior_weight * so3_log(E).reshape(-1))
        if len(constraints2d):
            wi = torch.einsum("nji,nj->ni", R[ci], bi)  # R^T b -> world ray
            wj = torch.einsum("nji,nj->ni", R[cj], bj)
            res.append(constraint_weight * torch.linalg.cross(wi, wj).reshape(-1))
        return torch.cat(res) if res else torch.zeros(1, **f32)

    w = torch.zeros((V, 3), **f32)
    eye = torch.eye(V * 3, **f32)
    for _ in range(iters):
        r = residuals(w)
        J = torch.func.jacfwd(residuals)(w).reshape(-1, V * 3).T  # (3V, M)
        step = -torch.linalg.solve(J @ J.T + 1e-8 * eye, J @ r).reshape(V, 3)
        w_new = w + step
        if float(torch.sum(residuals(w_new) ** 2)) < float(torch.sum(r * r)):
            w = w_new
    return (so3_exp(w * live) @ R0).cpu().numpy()
