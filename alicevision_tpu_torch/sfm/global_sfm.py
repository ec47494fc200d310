"""Global SfM: rotation averaging + translation averaging + triangulation.

Port of `alicevision_tpu/sfm/global_sfm.py` (ref:
src/aliceVision/sfm/pipeline/global/ReconstructionEngine_globalSfM.hpp:36-53,
GlobalSfMRotationAveragingSolver.cpp — L1 [Chatterjee] / L2 dense,
GlobalSfMTranslationAveragingSolver.cpp — L2-chordal / L1-soft;
multiview/rotationAveraging/l1.cpp, l2.cpp,
translationAveraging/solverL2Chordal.cpp).

Rotation averaging: the L2-chordal solution is the top-3 eigenvector block
of the pairwise rotation graph matrix (dense `eigh` on the device),
projected per camera to SO(3) by an SVD; an optional IRLS loop reweights
edges by residual for L1 robustness. Translation averaging: the L2-chordal
linear system over camera centers and per-edge baseline scales, built on
the host and solved as one float32 normal-equation system on the device,
with gauge fixing (c_0 = 0, mean scale = 1). The eigenvectors' sign and
order, and so the rotations' global gauge, may differ from the reference
package's: compare rotations after aligning the gauge.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.rotations import so3_exp, so3_log
from ..numeric import eigh, f32_matmuls, svd


def _index(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)


@f32_matmuls
def rotation_averaging_l2(
    n_views: int,
    edges: np.ndarray,  # (E, 2) view index pairs (i, j)
    R_rel: torch.Tensor,  # (E, 3, 3) with R_j = R_rel @ R_i (world->cam)
    weights: torch.Tensor | None = None,
    irls_iters: int = 0,
) -> torch.Tensor:
    """Global rotations (V, 3, 3) from pairwise relatives, L2-chordal, on
    R_rel's device.

    Builds G with blocks G[i, j] = w_ij R_ij^T (and G[j, i] = w_ij R_ij),
    takes the top-3 eigenvectors, orthonormalizes each 3x3 block via SVD.
    With irls_iters > 0, re-weights edges by 1/(chordal residual) for an
    L1-flavoured robust solution (the [Chatterjee] iteration in spirit).
    """
    dev, dt = R_rel.device, R_rel.dtype
    ii, jj = _index(edges[:, 0], dev), _index(edges[:, 1], dev)
    w = torch.ones(len(edges), dtype=dt, device=dev) if weights is None else weights
    ar3 = torch.arange(3, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)

    def solve(w):
        G = torch.zeros((3 * n_views, 3 * n_views), dtype=dt, device=dev)

        def put(a, b, blk, wt):
            rows = (3 * a[:, None, None] + ar3[None, :, None]).expand(-1, 3, 3)
            cols = (3 * b[:, None, None] + ar3[None, None, :]).expand(-1, 3, 3)
            G.index_put_((rows, cols), blk * wt[:, None, None], accumulate=True)

        # R_j = R_ij R_i  =>  blocks couple i and j
        put(ii, jj, R_rel.transpose(-1, -2), w)  # G[i,j] += R_ij^T
        put(jj, ii, R_rel, w)  # G[j,i] += R_ij
        # index_put_'s sorted accumulation, not index_add's atomics: the same
        # edges give the same bits on every run
        deg = torch.zeros(n_views, dtype=dt, device=dev).index_put_((torch.cat([ii, jj]),), torch.cat([w, w]),
                                                                     accumulate=True)
        G = G + torch.kron(torch.diag(deg), eye3)

        _, V = eigh(G)
        B = V[:, -3:].reshape(n_views, 3, 3)  # top-3 eigenvector blocks
        # The eigenvectors are only defined up to a common orthogonal mixing
        # Q; if Q is improper (det -1) the per-block SO(3) projections become
        # mutually inconsistent — fix the global chirality first.
        flip = torch.where(torch.sum(torch.linalg.det(B)) < 0, -1.0, 1.0).to(dt)
        B = torch.cat([B[..., :2], B[..., 2:] * flip], dim=-1)
        # Project each block onto SO(3).
        U, _, Vt = svd(B)
        det = torch.linalg.det(U @ Vt)
        D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
        R = U @ (D[..., :, None] * Vt)
        # Fix global gauge: R_0 = I.
        return torch.einsum("vij,kj->vik", R, R[0])

    R = solve(w)
    for _ in range(irls_iters):
        res = torch.linalg.norm(R[jj] - torch.einsum("eij,ejk->eik", R_rel, R[ii]), dim=(-2, -1))
        R = solve(1.0 / (res + 0.1))
    return R


@f32_matmuls
def rotation_averaging_l1(
    n_views: int,
    edges: np.ndarray,
    R_rel: torch.Tensor,
    outer_iters: int = 8,
    irls_eps: float = 1e-3,
) -> torch.Tensor:
    """L1 rotation averaging, IRLS in the tangent space [Chatterjee-Govindu]
    (ref: multiview/rotationAveraging/l1.cpp — same fixed point, different
    numerics: the reference runs sparse successive relaxation, here each
    IRLS step is one dense (V, V) solve on the device).

    Starts from the L2-chordal eigen solution, then repeats: per-edge
    residual r_e = log(R_j (R_ij R_i)^T), solve the graph Laplacian system
    for per-view tangent updates with weights 1/max(|r_e|, eps).
    """
    dev, dt = R_rel.device, R_rel.dtype
    ii, jj = _index(edges[:, 0], dev), _index(edges[:, 1], dev)
    R = rotation_averaging_l2(n_views, edges, R_rel)
    eye = torch.eye(n_views, dtype=dt, device=dev)
    for _ in range(outer_iters):
        # Residual rotation per edge; want delta_j - delta_i = -log M_e.
        M = torch.einsum("eij,ekj->eik", R[jj], torch.einsum("eij,ejk->eik", R_rel, R[ii]))
        r = so3_log(M)  # (E, 3)
        w = 1.0 / torch.clamp(torch.linalg.norm(r, dim=-1), min=irls_eps)
        # Weighted graph Laplacian over 3-vectors (block diagonal scalar).
        L = torch.zeros((n_views, n_views), dtype=dt, device=dev)
        L.index_put_((ii, jj), -w, accumulate=True)
        L.index_put_((jj, ii), -w, accumulate=True)
        L.index_put_((ii, ii), w, accumulate=True)
        L.index_put_((jj, jj), w, accumulate=True)
        # rhs: sum over incident edges of +-w r
        b = torch.zeros((n_views, 3), dtype=dt, device=dev)
        b.index_put_((torch.cat([jj, ii]),), torch.cat([-w[:, None] * r, w[:, None] * r]), accumulate=True)
        # Gauge: pin view 0.
        L[0, :] = 0.0
        L[:, 0] = 0.0
        L[0, 0] = 1.0
        b[0] = 0.0
        delta = torch.linalg.solve(L + 1e-9 * eye, b)  # (V, 3)
        R = torch.einsum("vij,vjk->vik", so3_exp(delta), R)
    # Re-fix gauge R_0 = I.
    return torch.einsum("vij,kj->vik", R, R[0])


def translation_averaging_l1soft(
    n_views: int,
    edges: np.ndarray,
    dirs_world,
    outer_iters: int = 6,
    irls_eps: float = 1e-3,
    device="cuda",
) -> torch.Tensor:
    """Soft-L1 translation averaging: IRLS over the L2-chordal system
    (ref: translationAveraging/solverL1Soft semantics — robust loss on the
    per-edge chordal residual, realized as reweighted dense solves). The
    residuals and weights are host numpy, each solve runs on `device`."""
    edges = np.asarray(edges)
    ii, jj = edges[:, 0], edges[:, 1]
    d = np.asarray(dirs_world.cpu() if isinstance(dirs_world, torch.Tensor) else dirs_world)
    d32 = d.astype(np.float32)  # the reference package solves with float32 directions
    c = translation_averaging_l2(n_views, edges, d32, device=device)
    for _ in range(outer_iters):
        cn = c.cpu().numpy()
        diff = cn[jj] - cn[ii]
        # Residual against the best per-edge scale (projection onto d).
        s = np.maximum(np.sum(diff * d, axis=-1), 1e-9)
        res = np.linalg.norm(diff - s[:, None] * d, axis=-1)
        w = 1.0 / np.sqrt(np.maximum(res, irls_eps))
        c = translation_averaging_l2(n_views, edges, d32, weights=w, device=device)
    return c


def rotation_residuals_deg(R: torch.Tensor, edges: np.ndarray, R_rel: torch.Tensor) -> torch.Tensor:
    """Per-edge angular residual of the averaged rotations (degrees)."""
    ii, jj = _index(edges[:, 0], R.device), _index(edges[:, 1], R.device)
    dR = torch.einsum("eij,ekj->eik", R[jj], torch.einsum("eij,ejk->eik", R_rel, R[ii]))
    return torch.rad2deg(torch.linalg.norm(so3_log(dR), dim=-1))


@f32_matmuls
def translation_averaging_l2(
    n_views: int,
    edges: np.ndarray,  # (E, 2)
    dirs_world,  # (E, 3) unit direction c_j - c_i in world frame
    weights=None,
    device="cuda",
) -> torch.Tensor:
    """Camera centers (V, 3) from pairwise baseline directions, L2-chordal.

    Unknowns x = [c_1..c_V, s_1..s_E]; equations c_j - c_i - s_e d_e = 0,
    gauge: c_0 = 0, sum(s) = E. The system is built in float64 numpy, and
    its normal equations are solved in float32 on `device` (on
    dirs_world's device when it is a tensor), as the reference package
    solves them.
    """
    if isinstance(dirs_world, torch.Tensor):
        dev = dirs_world.device
        d = dirs_world.detach().cpu().numpy()
    else:
        dev = resolve_device(device)
        d = np.asarray(dirs_world)
    E = len(edges)
    ii, jj = edges[:, 0], edges[:, 1]
    w = np.ones(E) if weights is None else np.asarray(weights)

    n_unk = 3 * n_views + E
    A = np.zeros((3 * E + 4, n_unk))
    b = np.zeros(3 * E + 4)
    for e in range(E):
        for k in range(3):
            r = 3 * e + k
            A[r, 3 * jj[e] + k] = w[e]
            A[r, 3 * ii[e] + k] = -w[e]
            A[r, 3 * n_views + e] = -w[e] * d[e, k]
    # gauge: c_0 = 0 (3 rows), mean scale = 1
    big = np.sqrt(E) * 10.0
    A[3 * E + 0, 0] = big
    A[3 * E + 1, 1] = big
    A[3 * E + 2, 2] = big
    A[3 * E + 3, 3 * n_views :] = 1.0
    b[3 * E + 3] = E

    f32 = dict(dtype=torch.float32, device=dev)
    AtA = torch.as_tensor(A.T @ A, **f32) + 1e-9 * torch.eye(n_unk, **f32)
    x = torch.linalg.solve(AtA, torch.as_tensor(A.T @ b, **f32))
    return x[: 3 * n_views].reshape(n_views, 3)


def relative_motions_from_poses(R_i, R_j, c_i, c_j):
    """Ground-truth-style helpers for tests: R_rel with R_j = R_rel R_i and
    world-frame unit baseline direction (host numpy)."""
    R_rel = R_j @ np.swapaxes(R_i, -1, -2)
    d = c_j - c_i
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return R_rel, d


class GlobalSfM:
    """Global reconstruction engine: relative poses -> averaging ->
    triangulation -> BA (ReconstructionEngine_globalSfM::process). The
    averaging runs on `device`."""

    def __init__(self, n_views, intr_table, view_intrinsic, image_sizes, device="cuda"):
        self.n_views = n_views
        self.intr = intr_table
        self.view_intrinsic = np.asarray(view_intrinsic)
        self.image_sizes = np.asarray(image_sizes)
        self.device = resolve_device(device)

    def run(
        self,
        edges: np.ndarray,
        R_rel: np.ndarray,
        dirs_ref: np.ndarray,
        tracks=None,
        features_xy=None,
        irls_iters: int = 3,
    ):
        """edges: (E,2); R_rel: (E,3,3) with R_j = R_rel R_i; dirs_ref: (E,3)
        unit t_ij in the *i-frame* (from essential decomposition: direction
        of c_j - c_i expressed in camera i). Returns numpy (R (V,3,3),
        c (V,3))."""
        R_t = torch.as_tensor(np.asarray(R_rel), dtype=torch.float32, device=self.device)
        R = rotation_averaging_l2(self.n_views, edges, R_t, irls_iters=irls_iters)
        # lift pairwise directions to world frame with averaged rotations
        Rn = R.cpu().numpy()
        d_world = np.einsum("eji,ej->ei", Rn[edges[:, 0]], np.asarray(dirs_ref))  # R_i^T d
        d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)
        c = translation_averaging_l2(self.n_views, edges, d_world.astype(np.float32), device=self.device)
        return Rn, c.cpu().numpy()
