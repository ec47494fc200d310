"""Bundle adjustment: Levenberg-Marquardt with explicit Schur complement.

Port of `alicevision_tpu/sfm/ba.py` (ref:
src/aliceVision/sfm/bundle/BundleAdjustmentCeres.cpp:38-140 residual costs,
:216-231 DENSE_SCHUR/SPARSE_SCHUR selection). The same algorithm and data
layout:

  * observations live in a (L, K) landmark-bucketed table (K = max track
    length, padded + masked); per-observation quantities are stacks of
    (K, L) planes;
  * residuals and their pose/point Jacobians use the closed-form geometric
    factors and the closed-form derivative of the intrinsic projection
    (forward mode, `torch.func.jvp`, for the joint intrinsics columns);
  * landmark blocks V_l (3x3) are eliminated in closed form, and the
    reduced camera system is solved densely (Cholesky) or matrix-free by
    preconditioned CG;
  * the LM loop accepts or rejects each step on the exactly evaluated cost.

What changed in the port: the per-camera broadcast is a gather
(`tbl.T[:, ocT]`) and the per-camera accumulation an `index_add_`, at every
size (the JAX package's one-hot products were TPU workarounds); the dense
elimination factor B is built by one `scatter_add_`; `lax.while_loop`
becomes a Python loop with the same exit test, which reads one value back
from the device per LM (or CG) iteration — `loop="unrolled"` runs exactly
`max_iters` iterations with convergence masking and reads nothing back.
`host_syncs` counts those reads.

The solver entry points run with full float32 matrix products (TF32 off,
`numeric.f32_matmuls`). Everything runs on the device of the problem's
tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import camera as cam
from ..device import resolve_device
from ..geometry.rotations import mat_to_quat, quat_to_mat, so3_exp
from ..numeric import f32_matmuls

_EPS = 1e-12

# Values read back from the device to steer a loop (the LM and CG exit
# tests of loop="while") since the last reset; a plain count.
host_syncs = 0


def _sync_bool(x: torch.Tensor) -> bool:
    global host_syncs
    host_syncs += 1
    return bool(x)


class BAProblem(NamedTuple):
    """Static-shape BA problem. All index arrays refer to table rows.

    Rig support: when sub_q/sub_t/obs_sub are set, the world->camera
    transform of an observation is x_cam = R_sub x_frame + t_sub with
    x_frame = R(cam_q)(X - cam_c); cam_q/cam_c are then the shared frame
    (rig) poses and each observation selects its sub-pose via obs_sub.
    Sub-pose 0 must be the identity."""

    cam_q: torch.Tensor  # (C, 4) world->cam (or world->frame) quaternion
    cam_c: torch.Tensor  # (C, 3) centers
    points: torch.Tensor  # (L, 3)
    intr: cam.Intrinsics  # batched (I,)
    obs_cam: torch.Tensor  # (L, K) int32 camera index (0 if masked)
    obs_intr: torch.Tensor  # (L, K) int32 intrinsic index
    obs_uv: torch.Tensor  # (L, K, 2) pixel observations
    obs_mask: torch.Tensor  # (L, K) bool
    cam_fixed: torch.Tensor  # (C,) bool — pose held CONSTANT
    point_fixed: torch.Tensor  # (L,) bool
    sub_q: torch.Tensor = None  # (S, 4) rig sub-pose rotations (0 = identity)
    sub_t: torch.Tensor = None  # (S, 3) rig sub-pose translations
    obs_sub: torch.Tensor = None  # (L, K) int32 sub-pose index


class BAResult(NamedTuple):
    cam_q: torch.Tensor
    cam_c: torch.Tensor
    points: torch.Tensor
    cost_initial: torch.Tensor
    cost_final: torch.Tensor
    n_iters: torch.Tensor


def _tensor(x, dtype, dev):
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def build_problem(
    cam_q,
    cam_c,
    points,
    intr,
    obs_lm,
    obs_cam,
    obs_intr,
    obs_uv,
    max_track: int = 16,
    cam_fixed=None,
    point_fixed=None,
    obs_sub=None,
    sub_q=None,
    sub_t=None,
    device="cuda",
) -> BAProblem:
    """Bucket flat observation arrays into the (L, K) table on the host and
    place the problem on `device`."""
    dev = resolve_device(device)

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    obs_lm = host(obs_lm)
    L = len(points)
    K = max_track
    # rank of each observation within its landmark group (stable sort +
    # group-offset subtraction) gives its K slot; observations past K drop
    order = np.argsort(obs_lm, kind="stable")
    sorted_lm = obs_lm[order]
    bounds = np.searchsorted(sorted_lm, np.arange(L + 1))
    slot = np.arange(len(obs_lm)) - bounds[sorted_lm]
    keep = slot < K
    rows = sorted_lm[keep]
    cols = slot[keep]
    src = order[keep]
    t_cam = np.zeros((L, K), np.int32)
    t_intr = np.zeros((L, K), np.int32)
    t_uv = np.zeros((L, K, 2), np.float32)
    t_mask = np.zeros((L, K), bool)
    t_cam[rows, cols] = host(obs_cam)[src]
    t_intr[rows, cols] = host(obs_intr)[src]
    t_uv[rows, cols] = host(obs_uv)[src]
    t_mask[rows, cols] = True
    t_sub = None
    if obs_sub is not None:
        t_sub = np.zeros((L, K), np.int32)
        t_sub[rows, cols] = host(obs_sub)[src]
    C = len(cam_c)
    intr_t = cam.Intrinsics(
        *(_tensor(host(a), torch.int32 if n in ("cam_kind", "disto_kind") else torch.float32, dev)
          for n, a in zip(cam.Intrinsics._fields, intr))
    )
    return BAProblem(
        cam_q=_tensor(host(cam_q), torch.float32, dev),
        cam_c=_tensor(host(cam_c), torch.float32, dev),
        points=_tensor(host(points), torch.float32, dev),
        intr=intr_t,
        obs_cam=torch.from_numpy(t_cam).to(dev),
        obs_intr=torch.from_numpy(t_intr).to(dev),
        obs_uv=torch.from_numpy(t_uv).to(dev),
        obs_mask=torch.from_numpy(t_mask).to(dev),
        cam_fixed=torch.zeros((C,), dtype=torch.bool, device=dev)
        if cam_fixed is None else _tensor(host(cam_fixed), torch.bool, dev),
        point_fixed=torch.zeros((L,), dtype=torch.bool, device=dev)
        if point_fixed is None else _tensor(host(point_fixed), torch.bool, dev),
        sub_q=None if sub_q is None else _tensor(host(sub_q), torch.float32, dev),
        sub_t=None if sub_t is None else _tensor(host(sub_t), torch.float32, dev),
        obs_sub=None if t_sub is None else torch.from_numpy(t_sub).to(dev),
    )


def _bcast_rows(tbl, ocT):
    """Broadcast per-camera rows tbl (..., C, D) to observations ->
    (..., D, K, L): a gather of the transposed table, so the output lands in
    plane layout."""
    return tbl.transpose(-1, -2)[..., ocT]


def _accum_cams(planes, ocT, C):
    """Accumulate per-observation planes (..., D, K, L) into (..., C, D) rows.

    Values must already carry the observation mask (zero where invalid). One
    `index_add_` over the flattened observations (float atomics on CUDA, so
    the order of the sums varies from run to run)."""
    lead = planes.shape[:-2]
    flat = planes.reshape(lead + (-1,))
    out = planes.new_zeros(lead[:-1] + (lead[-1], C))
    out.index_add_(out.dim() - 1, ocT.reshape(-1), flat)
    return out.transpose(-1, -2)


def _intr_rows(intr: cam.Intrinsics, idx) -> cam.Intrinsics:
    """Gather intrinsic rows per observation."""
    return cam.Intrinsics(*(a[idx] for a in intr))


def _apply_subpose(problem: BAProblem, ux, uy, uz, sub_q=None, sub_t=None):
    """x_cam components from x_frame via the per-obs rig sub-pose.

    Returns (xc, yc, zc, Rs) with Rs the 9 broadcast rotation planes (None
    for the non-rig path)."""
    if problem.sub_q is None:
        return ux, uy, uz, None
    sq = problem.sub_q if sub_q is None else sub_q
    st = problem.sub_t if sub_t is None else sub_t
    S = sq.shape[0]
    tblS = torch.cat([quat_to_mat(sq).reshape(S, 9), st], dim=1)
    gs = _bcast_rows(tblS, problem.obs_sub.T)  # (12, K, L)
    Rs = [gs[i] for i in range(9)]
    xc = Rs[0] * ux + Rs[1] * uy + Rs[2] * uz + gs[9]
    yc = Rs[3] * ux + Rs[4] * uy + Rs[5] * uz + gs[10]
    zc = Rs[6] * ux + Rs[7] * uy + Rs[8] * uz + gs[11]
    return xc, yc, zc, Rs


def _intr_apply(intr: cam.Intrinsics, dtheta) -> cam.Intrinsics:
    """Apply packed intrinsic deltas (I, 4 + DISTO_PARAMS):
    [d_fx, d_fy, d_cx, d_cy, d_disto...]."""
    return intr._replace(
        scale=intr.scale + dtheta[:, 0:2],
        offset=intr.offset + dtheta[:, 2:4],
        disto=intr.disto + dtheta[:, 4:],
    )


def _frame_coords(problem: BAProblem, cam_q, cam_c, points):
    """Per-observation rotation planes R (9 x (K, L)) and x_frame
    components (ux, uy, uz) = R (X - c)."""
    C = cam_q.shape[0]
    tblC = torch.cat([quat_to_mat(cam_q).reshape(C, 9), cam_c], dim=1)
    g = _bcast_rows(tblC, problem.obs_cam.T)  # (12, K, L)
    R = [g[i] for i in range(9)]  # R[3*i+j] = R_ij per observation
    vx = points[:, 0][None] - g[9]  # (K, L)
    vy = points[:, 1][None] - g[10]
    vz = points[:, 2][None] - g[11]
    ux = R[0] * vx + R[1] * vy + R[2] * vz
    uy = R[3] * vx + R[4] * vy + R[5] * vz
    uz = R[6] * vx + R[7] * vy + R[8] * vz
    return R, ux, uy, uz


def _residual_planes(problem: BAProblem, pix):
    """r (2, K, L) = projected pixels (K, L, 2) - observed."""
    uv = problem.obs_uv
    return torch.stack([pix[..., 0] - uv[..., 0].T, pix[..., 1] - uv[..., 1].T])


def _residuals(problem: BAProblem, cam_q, cam_c, points, sub_q=None, sub_t=None, intr=None):
    """r (2, K, L) only — the cheap path for cost evaluation (same
    observation-minor layout as _residuals_and_jacobians)."""
    _, ux, uy, uz = _frame_coords(problem, cam_q, cam_c, points)
    xc, yc, zc, _ = _apply_subpose(problem, ux, uy, uz, sub_q, sub_t)
    u = torch.stack([xc, yc, zc], -1)  # (K, L, 3)
    intr_cur = problem.intr if intr is None else intr
    pix = cam.project_cam(_intr_rows(intr_cur, problem.obs_intr.T), u)
    return _residual_planes(problem, pix)


def _residuals_and_jacobians(problem: BAProblem, cam_q, cam_c, points, dtheta=None, intr_param_idx=None):
    """r (2,K,L), J_c (2,6,K,L), J_l (2,3,K,L) — analytic chain rule in
    observation-minor layout. With `dtheta` (I, 4+DISTO_PARAMS) and an
    `intr_param_idx` tuple, additionally returns J_t (2, I*len(idx), K, L):
    the shared-intrinsics Jacobian columns of the joint refinement.

    Only the intrinsic projection pix(x_cam) is differentiated: in closed
    form (`camera.project_cam_jacobian`) for the pose/point columns, and by
    forward mode (`torch.func.jvp` on a batch that replicates the
    observations once per tangent direction) where the intrinsic columns
    are wanted too; the geometric part uses the closed-form factors
      d x_cam / d rot = -[x_cam]_x,  d x_cam / d c = -R,  d x_cam / d X = R
    (ref: sfm/bundle/costfunctions/projection.hpp:14-30)."""
    R, ux, uy, uz = _frame_coords(problem, cam_q, cam_c, points)
    # rig chain: linearize the projection at x_cam = R_sub x_frame + t_sub,
    # then fold R_sub into A so the geometric factors stay written in terms
    # of x_frame (J_rot = -A_eff [x_frame]x, J_pt = A_eff R_frame).
    xc, yc, zc, Rs = _apply_subpose(problem, ux, uy, uz)
    u = torch.stack([xc, yc, zc], -1)  # (K, L, 3)
    oiT = problem.obs_intr.T
    eye3 = torch.eye(3, dtype=u.dtype, device=u.device)

    if dtheta is None:
        pix, Jpix = cam.project_cam_jacobian(_intr_rows(problem.intr, oiT), u)
        Acols = [Jpix[..., i] for i in range(3)]  # 3 x (K, L, 2)
        Jt_cols = None
    else:
        intr_cur = _intr_apply(problem.intr, dtheta)
        I, n_p = dtheta.shape
        cols = [(gi, p) for gi in range(I) for p in intr_param_idx]
        B = 3 + len(cols)
        kind_rows = intr_cur.cam_kind[oiT]
        dkind_rows = intr_cur.disto_kind[oiT]
        size_rows = intr_cur.size[oiT]

        def fproj(xcam, dp):  # xcam (B, K, L, 3), dp (B, I, n_p)
            rows = cam.Intrinsics(
                cam_kind=kind_rows,
                disto_kind=dkind_rows,
                scale=(intr_cur.scale[None] + dp[:, :, 0:2])[:, oiT],
                offset=(intr_cur.offset[None] + dp[:, :, 2:4])[:, oiT],
                size=size_rows,
                disto=(intr_cur.disto[None] + dp[:, :, 4:])[:, oiT],
            )
            return cam.project_cam(rows, xcam)

        uB = u.unsqueeze(0).repeat(B, 1, 1, 1)
        t_u = torch.zeros_like(uB)
        t_u[:3] = eye3[:, None, None, :]
        dpB = torch.zeros((B, I, n_p), dtype=u.dtype, device=u.device)
        t_dp = torch.zeros_like(dpB)
        for n, (gi, p) in enumerate(cols):
            t_dp[3 + n, gi, p] = 1.0
        pixB, tanB = torch.func.jvp(fproj, (uB, dpB), (t_u, t_dp))
        pix = pixB[0]
        Acols = [tanB[i] for i in range(3)]
        Jt_cols = [tanB[3 + n] for n in range(len(cols))]  # (K, L, 2) each

    A = [[Acols[i][..., r] for i in range(3)] for r in range(2)]  # A[r][i]
    if Rs is not None:  # A_eff = A @ R_sub
        A = [
            [
                A[r_][0] * Rs[0] + A[r_][1] * Rs[3] + A[r_][2] * Rs[6],
                A[r_][0] * Rs[1] + A[r_][1] * Rs[4] + A[r_][2] * Rs[7],
                A[r_][0] * Rs[2] + A[r_][1] * Rs[5] + A[r_][2] * Rs[8],
            ]
            for r_ in range(2)
        ]

    r_out = _residual_planes(problem, pix)  # (2, K, L)
    rot_rows, pt_rows = [], []
    for r_ in range(2):
        a0, a1, a2 = A[r_]
        # J_rot = -A [u]_x ; J_pt = A R
        rot_rows.append(
            torch.stack([-(a1 * uz - a2 * uy), -(-a0 * uz + a2 * ux), -(a0 * uy - a1 * ux)])
        )
        pt_rows.append(
            torch.stack(
                [
                    a0 * R[0] + a1 * R[3] + a2 * R[6],
                    a0 * R[1] + a1 * R[4] + a2 * R[7],
                    a0 * R[2] + a1 * R[5] + a2 * R[8],
                ]
            )
        )
    J_pt = torch.stack(pt_rows)  # (2, 3, K, L)
    Jc = torch.cat([torch.stack(rot_rows), -J_pt], dim=1)  # (2, 6, K, L); d x_cam/d c = -R
    if Jt_cols is None:
        return r_out, Jc, J_pt
    Jt = torch.stack([col.permute(2, 0, 1) for col in Jt_cols], dim=1)  # (2, P, K, L)
    return r_out, Jc, J_pt, Jt


def _quat_premul_mat(dq_mat, q):
    """Apply rotation-matrix increment to quaternion: R_new = dR R(q)."""
    return mat_to_quat(dq_mat @ quat_to_mat(q))


def _sym3_inv(A):
    """Closed-form inverse of batched symmetric 3x3 matrices (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e = A[..., 1, 1], A[..., 1, 2]
    f = A[..., 2, 2]
    i00, i01, i02, i11, i12, i22 = _sym3_inv_c(a, b, c, d, e, f)
    row0 = torch.stack([i00, i01, i02], -1)
    row1 = torch.stack([i01, i11, i12], -1)
    row2 = torch.stack([i02, i12, i22], -1)
    return torch.stack([row0, row1, row2], -2)


def _chol3(A):
    """Closed-form Cholesky of batched SPD 3x3 matrices (lower factor)."""
    l11, l21, l31, l22, l32, l33 = _chol3_c(
        A[..., 0, 0], A[..., 1, 0], A[..., 2, 0], A[..., 1, 1], A[..., 2, 1], A[..., 2, 2]
    )
    z = torch.zeros_like(l11)
    row0 = torch.stack([l11, z, z], -1)
    row1 = torch.stack([l21, l22, z], -1)
    row2 = torch.stack([l31, l32, l33], -1)
    return torch.stack([row0, row1, row2], -2)


def _sym3_inv_c(a, b, c, d, e, f):
    """Closed-form inverse of symmetric 3x3 given the six unique components
    (upper triangle: a=00, b=01, c=02, d=11, e=12, f=22) as same-shape
    tensors. Returns the six components of the inverse."""
    co_a = d * f - e * e
    co_b = c * e - b * f
    co_c = b * e - c * d
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / torch.where(torch.abs(det) < _EPS, torch.full_like(det, _EPS), det)
    return (
        co_a * inv_det,
        co_b * inv_det,
        co_c * inv_det,
        (a * f - c * c) * inv_det,
        (b * c - a * e) * inv_det,
        (a * d - b * b) * inv_det,
    )


def _chol3_c(a, b, c, d, e, f):
    """Closed-form lower Cholesky of SPD 3x3 from the six unique components
    (a=00, b=01, c=02, d=11, e=12, f=22). Returns (l11, l21, l31, l22,
    l32, l33)."""
    l11 = torch.sqrt(torch.clamp(a, min=_EPS))
    l21 = b / l11
    l31 = c / l11
    l22 = torch.sqrt(torch.clamp(d - l21 * l21, min=_EPS))
    l32 = (e - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(f - l31 * l31 - l32 * l32, min=_EPS))
    return l11, l21, l31, l22, l32, l33


# The 21 unique (i <= j) entries of a symmetric 6x6 block, row-major, and
# the map from each of the 36 entries back to its unique slot.
_IU = [(i, j) for i in range(6) for j in range(i, 6)]
_SYM6 = [_IU.index((min(i, j), max(i, j))) for i in range(6) for j in range(6)]


_INDEX_CACHE: dict = {}


def _index_tensors(device):
    """(ii, jj, sym6) index tensors on `device`, made once: a tensor built
    from a host list is a host-to-device copy, which would stall the stream
    every LM iteration."""
    key = str(device)
    if key not in _INDEX_CACHE:
        _INDEX_CACHE[key] = tuple(
            torch.tensor(v, device=device)
            for v in ([i for i, _ in _IU], [j for _, j in _IU], _SYM6)
        )
    return _INDEX_CACHE[key]


def _iu_index(device):
    return _index_tensors(device)[:2]


def _sym6(comp):
    """(C, 21) unique components -> (C, 6, 6) symmetric blocks."""
    return comp[:, _index_tensors(comp.device)[2]].reshape(-1, 6, 6)


class _SchurParts(NamedTuple):
    """Shared Schur-elimination pieces, observation-minor layout."""

    ocT: torch.Tensor  # (K, L) camera index per observation
    g_c: torch.Tensor  # (C, 6) camera gradient
    b: torch.Tensor  # (C, 6) reduced RHS
    U_d: torch.Tensor  # (C, 6, 6) damped camera diagonal blocks
    Vi: tuple  # 6 components of V^-1, each (L,)
    Vh: tuple  # (l11, l21, l31, l22, l32, l33) of chol(V^-1), each (L,)
    W: torch.Tensor  # (6, 3, K, L)
    Y: torch.Tensor  # (6, 3, K, L), Y = W chol(V^-1)
    g_l: torch.Tensor  # (3, L) landmark gradient


def _live_masks(problem, dtype):
    mT = problem.obs_mask.T.to(dtype)  # (K, L)
    live_cam = (~problem.cam_fixed).to(dtype)[problem.obs_cam.T] * mT
    live_pt = (~problem.point_fixed).to(dtype)[None] * mT
    return mT, live_cam, live_pt


def _reduce_sum(reduce, *ts):
    """`reduce` (a sum across ranks) of several tensors in one call."""
    flat = reduce(torch.cat([t.reshape(-1) for t in ts]))
    return [p.reshape(t.shape) for p, t in zip(flat.split([t.numel() for t in ts]), ts)]


def _schur_prelude(problem, r, Jc, Jl, lam, reduce=None) -> _SchurParts:
    """Eliminate the landmark blocks and build everything both reduced-camera
    solvers share. Per-landmark block algebra (V, W, the chol(V^-1)
    elimination) is elementwise over (K, L) planes; per-camera reductions go
    through _accum_cams.

    With `reduce` (a sum over ranks that each hold a block of the
    landmarks, `parallel/ba_sharded.py`), the camera-sized sums U, g_c and
    b are summed across ranks in one call before U is damped, so the
    damping counts once."""
    C = problem.cam_q.shape[0]
    ocT = problem.obs_cam.T  # (K, L)
    mT, live_cam, live_pt = _live_masks(problem, r.dtype)

    # Zero Jacobians of fixed parameters (makes them CONSTANT) + mask.
    Jc = Jc * live_cam
    Jl = Jl * live_pt
    r = r * mT

    # V (3x3 sym): six unique components, each (L,), summed over r and k.
    V = {}
    for i in range(3):
        for j in range(i, 3):
            V[(i, j)] = torch.sum(Jl[0, i] * Jl[0, j] + Jl[1, i] * Jl[1, j], dim=0)
    g_l = -torch.sum(Jl * r[:, None], dim=(0, 2))  # (3, L)

    # U: 21 unique components of J_c^T J_c per camera; g_c.
    ii, jj = _iu_index(r.device)
    JJ = Jc[0, ii] * Jc[0, jj] + Jc[1, ii] * Jc[1, jj]  # (21, K, L)
    U21 = _accum_cams(JJ, ocT, C)  # (C, 21)
    Jr = Jc[0] * r[0] + Jc[1] * r[1]  # (6, K, L)
    g_c = -_accum_cams(Jr, ocT, C)  # (C, 6)

    # LM damping (multiplicative on the diagonal, Marquardt style).
    dampV = 1.0 + lam
    Vd = {
        (i, j): V[(i, j)] * dampV + 1e-9 if i == j else V[(i, j)]
        for (i, j) in V
    }
    Vi = _sym3_inv_c(Vd[(0, 0)], Vd[(0, 1)], Vd[(0, 2)], Vd[(1, 1)], Vd[(1, 2)], Vd[(2, 2)])
    l11, l21, l31, l22, l32, l33 = _chol3_c(*Vi)  # V^-1 = Vh Vh^T (lower)

    # W (6x3 per obs): W[i][h] = sum_r Jc[r,i] * Jl[r,h].
    W = Jc[0][:, None] * Jl[0][None] + Jc[1][:, None] * Jl[1][None]  # (6, 3, K, L)
    # Y = W Vh (lower-triangular): Y[i][h] = sum_{j>=h} W[i][j] Vh[j][h]
    Y = torch.stack(
        [
            W[:, 0] * l11 + W[:, 1] * l21 + W[:, 2] * l31,
            W[:, 1] * l22 + W[:, 2] * l32,
            W[:, 2] * l33,
        ],
        dim=1,
    )

    # RHS: b = g_c - sum_lk accum(Y (Vh^T g_l)).
    gls = _vh_t(l11, l21, l31, l22, l32, l33, g_l)  # (3, L)
    corr = Y[:, 0] * gls[0] + Y[:, 1] * gls[1] + Y[:, 2] * gls[2]  # (6, K, L)
    b = g_c - _accum_cams(corr, ocT, C)
    if reduce is not None:
        U21, g_c, b = _reduce_sum(reduce, U21, g_c, b)
    U = _sym6(U21)  # (C, 6, 6)
    eyeU = torch.eye(6, dtype=r.dtype, device=r.device)
    U_d = U + lam * (U * eyeU) + 1e-9 * eyeU

    return _SchurParts(
        ocT=ocT, g_c=g_c, b=b, U_d=U_d, Vi=Vi,
        Vh=(l11, l21, l31, l22, l32, l33), W=W, Y=Y, g_l=g_l,
    )


def _vh_t(l11, l21, l31, l22, l32, l33, g):
    """Vh^T g for per-landmark lower factors and vectors g (3, L)."""
    return torch.stack(
        [l11 * g[0] + l21 * g[1] + l31 * g[2], l22 * g[1] + l32 * g[2], l33 * g[2]]
    )


def _vi_apply(Vi, rhs):
    """V^-1 rhs for the six components of V^-1 and rhs (3, L) -> (L, 3)."""
    ia, ib, ic, id_, ie, if_ = Vi
    return torch.stack(
        [
            ia * rhs[0] + ib * rhs[1] + ic * rhs[2],
            ib * rhs[0] + id_ * rhs[1] + ie * rhs[2],
            ic * rhs[0] + ie * rhs[1] + if_ * rhs[2],
        ],
        dim=-1,
    )


def _back_substitute(parts: _SchurParts, dx_cam):
    """dx_l = V^-1 (g_l - sum_k W^T dx_cam) given the camera step."""
    dxc = _bcast_rows(dx_cam, parts.ocT)  # (6, K, L)
    t = torch.sum(parts.W * dxc[:, None], dim=(0, 2))  # (3, L)
    return _vi_apply(parts.Vi, parts.g_l - t)


def _elimination_factor(parts: _SchurParts, C: int):
    """B (6C, 3L) with B[(c,i), (h,l)] = sum_k [cam(l,k) = c] Y[i][h](k, l),
    built by one scatter of Y into a (C, 18, L) zero tensor. A landmark sees
    a camera at most once, so only masked slots (camera 0, Y = 0) collide."""
    K, L = parts.ocT.shape
    Y18 = parts.Y.reshape(18, K, L)
    B = Y18.new_zeros((C, 18, L))
    idx = parts.ocT.long()[:, None, :].expand(K, 18, L)
    B.scatter_add_(0, idx, Y18.permute(1, 0, 2))
    return B.reshape(C * 6, 3 * L)


def _reduced_camera_matrix(parts: _SchurParts, Bm, C: int, reduce=None):
    """S = blockdiag(U_d) - B B^T (6C x 6C), symmetric by construction.
    With `reduce`, -B B^T is summed over the ranks' landmark blocks before
    the (already summed) damped diagonal is added."""
    S = -(Bm @ Bm.T)
    if reduce is not None:
        S = reduce(S)
    S.view(C, 6, C, 6).diagonal(dim1=0, dim2=2).add_(parts.U_d.permute(1, 2, 0))
    return S


def _chol_solve(S, rhs):
    """Solve S x = rhs for SPD S by Cholesky, without a host sync: a matrix
    that is not positive definite gives NaN (the LM step is then rejected),
    as the reference's solve(assume_a="pos") does."""
    Lc, info = torch.linalg.cholesky_ex(S)
    x = torch.cholesky_solve(rhs[:, None], Lc)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def _schur_solve(problem, r, Jc, Jl, lam, reduce=None):
    """One damped Schur step via DENSE solve: (dx_cam (C,6), dx_pt (L,3)).

    S_off = -B B^T with B = W chol(V^-1) scattered per camera; suitable up
    to a few hundred cameras (ref: DENSE_SCHUR below 100 poses,
    BundleAdjustmentCeres.cpp:216-231)."""
    C = problem.cam_q.shape[0]
    parts = _schur_prelude(problem, r, Jc, Jl, lam, reduce)
    S = _reduced_camera_matrix(parts, _elimination_factor(parts, C), C, reduce)
    S.diagonal().add_(1e-8)
    dx_cam = _chol_solve(S, parts.b.reshape(C * 6)).reshape(C, 6)
    return dx_cam, _back_substitute(parts, dx_cam)


def _schur_solve_joint(problem, r, Jc, Jl, Jt, lam, colmask=None):
    """Damped Schur step of the JOINT pose/point/shared-intrinsics system:
    returns (dx_cam (C,6), dx_pt (L,3), dtheta (P,)). The reduced system
    gains P rows/cols, eliminated against the landmark blocks like S_cc."""
    K, L = problem.obs_cam.T.shape
    C = problem.cam_q.shape[0]
    parts = _schur_prelude(problem, r, Jc, Jl, lam)
    mT, live_cam, live_pt = _live_masks(problem, r.dtype)
    P = Jt.shape[1]
    Jt = Jt * mT  # (2, P, K, L)
    if colmask is not None:
        # a zeroed column + identity diagonal row below makes the masked
        # parameter's step exactly 0
        Jt = Jt * colmask[None, :, None, None]
    Jc_m = Jc * live_cam
    Jl_m = Jl * live_pt
    r_m = r * mT

    # per-landmark intrinsics-point coupling W_t (P, 3, L)
    wth = torch.sum(Jt[0][:, None] * Jl_m[0][None] + Jt[1][:, None] * Jl_m[1][None], dim=2)
    U_t = torch.sum(Jt[0][:, None] * Jt[0][None] + Jt[1][:, None] * Jt[1][None], dim=(2, 3))
    g_t = -torch.sum(Jt[0] * r_m[0] + Jt[1] * r_m[1], dim=(1, 2))
    # W_ct (C, 6, P) camera-intrinsics coupling
    planes = (Jc_m[0][:, None] * Jt[0][None] + Jc_m[1][:, None] * Jt[1][None]).reshape(6 * P, K, L)
    W_ct = _accum_cams(planes, parts.ocT, C).reshape(C, 6, P)

    # eliminate landmarks: Y_t = W_t chol(V^-1)
    l11, l21, l31, l22, l32, l33 = parts.Vh
    Y_t = torch.stack(
        [
            wth[:, 0] * l11 + wth[:, 1] * l21 + wth[:, 2] * l31,
            wth[:, 1] * l22 + wth[:, 2] * l32,
            wth[:, 2] * l33,
        ],
        dim=1,
    )  # (P, 3, L)
    Y_tm = Y_t.reshape(P, 3 * L)

    Bm = _elimination_factor(parts, C)
    S_cc = _reduced_camera_matrix(parts, Bm, C)
    S_ct = W_ct.reshape(C * 6, P) - Bm @ Y_tm.T
    eyeP = torch.eye(P, dtype=r.dtype, device=r.device)
    U_td = U_t + lam * (U_t * eyeP) + 1e-9 * eyeP
    S_tt = U_td - Y_tm @ Y_tm.T
    if colmask is not None:
        S_tt = S_tt + torch.diag(1.0 - colmask)

    gls = _vh_t(l11, l21, l31, l22, l32, l33, parts.g_l)
    b_t = g_t - Y_tm @ gls.reshape(3 * L)

    S_full = torch.cat([torch.cat([S_cc, S_ct], 1), torch.cat([S_ct.T, S_tt], 1)], 0)
    S_full.diagonal().add_(1e-8)
    dx = _chol_solve(S_full, torch.cat([parts.b.reshape(C * 6), b_t]))
    dx_cam = dx[: C * 6].reshape(C, 6)
    dtheta = dx[C * 6:]

    # back-substitution with the intrinsics correction:
    # dx_l = V^-1 (g_l - W_cl^T dx_cam - W_tl^T dtheta)
    dxc = _bcast_rows(dx_cam, parts.ocT)
    t = torch.sum(parts.W * dxc[:, None], dim=(0, 2)) + torch.sum(wth * dtheta[:, None, None], dim=0)
    return dx_cam, _vi_apply(parts.Vi, parts.g_l - t), dtheta


def _s_operator(parts: _SchurParts, C: int, dtype, reduce=None):
    """(S_apply, M_apply) — the matrix-free reduced-camera operator and its
    SCHUR_JACOBI preconditioner, for x of shape (..., C, 6): a leading batch
    of right-hand sides is solved at once. With `reduce`, the landmark sums
    (the preconditioner's once, each matvec's once) are summed across
    ranks."""
    Y, U_d, ocT = parts.Y, parts.U_d, parts.ocT

    # SCHUR_JACOBI preconditioner: exact diagonal blocks of S (a landmark
    # observes each camera at most once).
    ii, jj = _iu_index(Y.device)
    YY = torch.sum(Y[ii] * Y[jj], dim=1)  # (21, K, L)
    YY_c = _accum_cams(YY, ocT, C)
    if reduce is not None:
        YY_c = reduce(YY_c)
    Sd = U_d - _sym6(YY_c)
    Sd = Sd + 1e-8 * torch.eye(6, dtype=dtype, device=Y.device)
    Minv = torch.linalg.inv_ex(Sd)[0]  # (C, 6, 6) batched tiny inverses

    def S_apply(x):
        ux = torch.einsum("cij,...cj->...ci", U_d, x)
        xo = _bcast_rows(x, ocT)  # (..., 6, K, L)
        # th[h] = sum_{k,i} Y[i][h] * x_obs[i] per landmark
        th = torch.sum(Y * xo[..., :, None, :, :], dim=(-4, -2))  # (..., 3, L)
        corr = torch.sum(Y * th[..., None, :, None, :], dim=-3)  # (..., 6, K, L)
        acc = _accum_cams(corr, ocT, C)
        if reduce is not None:
            acc = reduce(acc)
        return ux - acc

    def M_apply(v):
        return torch.einsum("cij,...cj->...ci", Minv, v)

    return S_apply, M_apply


def _schur_solve_pcg(problem, r, Jc, Jl, lam, cg_iters: int = 100, cg_tol: float = 1e-2,
                     loop: str = "while", x_warm=None, reduce=None):
    """Matrix-free PCG on the reduced camera system S dx = b.

    Never materializes S or B: each matvec streams the observation table
    twice (broadcast + accumulate), so memory stays O(K*L). The large-scene
    analog of the reference's ITERATIVE_SCHUR with SCHUR_JACOBI
    (BundleAdjustmentCeres.cpp:216-231). loop="while" stops when
    |res|^2 <= cg_tol^2 |b|^2 (one host read per CG iteration); "fori" runs
    exactly cg_iters iterations with convergence masking."""
    C = problem.cam_q.shape[0]
    parts = _schur_prelude(problem, r, Jc, Jl, lam, reduce)
    S_apply, M_apply = _s_operator(parts, C, r.dtype, reduce)

    b = parts.b
    tol2 = (cg_tol * cg_tol) * torch.sum(b * b) + 1e-30

    def body(x, res, z, p):
        Sp = S_apply(p)
        rz = torch.sum(res * z)
        alpha = rz / torch.sum(p * Sp).clamp(min=_EPS)
        x = x + alpha * p
        res_n = res - alpha * Sp
        z_n = M_apply(res_n)
        beta = torch.sum(res_n * z_n) / rz.clamp(min=_EPS)
        return x, res_n, z_n, p * beta + z_n

    if x_warm is None:
        x0, res0 = torch.zeros_like(b), b
    else:
        # Warm start from the previous LM iteration's accepted step: the
        # reduced systems of consecutive LM iterations share most of their
        # spectrum, so the prior solution is a far better seed than 0.
        x0, res0 = x_warm, b - S_apply(x_warm)
    z0 = M_apply(res0)
    state = (x0, res0, z0, z0)
    for _ in range(cg_iters):
        active = torch.sum(state[1] * state[1]) > tol2
        if loop == "while":
            if not _sync_bool(active):
                break
            state = body(*state)
        else:
            new = body(*state)
            state = tuple(torch.where(active, n, o) for n, o in zip(new, state))
    dx_cam = state[0]
    return dx_cam, _back_substitute(parts, dx_cam)


def _robust_cost(problem, r, huber):
    n = torch.sqrt(r[0] * r[0] + r[1] * r[1])
    rho = torch.where(n <= huber, 0.5 * n * n, huber * (n - 0.5 * huber))
    return torch.sum(torch.where(problem.obs_mask.T, rho, 0.0))


def _cost(problem, cam_q, cam_c, points, huber_delta, reduce=None):
    cost = _robust_cost(problem, _residuals(problem, cam_q, cam_c, points), huber_delta)
    return cost if reduce is None else reduce(cost.reshape(1)).reshape(())


def _irls_weights(problem, r, huber):
    """Huber IRLS sqrt-weights (K, L) on the residual norm, masked."""
    n = torch.sqrt(r[0] * r[0] + r[1] * r[1])
    w = torch.where(n <= huber, 1.0, torch.sqrt(huber / n.clamp(min=_EPS)))
    return w * problem.obs_mask.T


# Cameras above which ba_solve(solver="auto") switches from the dense
# reduced-camera solve to matrix-free PCG (the reference flips DENSE_SCHUR
# -> SPARSE_SCHUR at 100 poses, BundleAdjustmentCeres.cpp:216-231), and the
# cap on the dense path's (6C, 3L) float32 factor B: 1.5 GB.
_DENSE_SCHUR_MAX_CAMS = 192
_DENSE_B_MAX_BYTES = 3 << 29


def _auto_solver(C: int, L: int) -> str:
    """The solver that ba_solve(solver="auto") picks for C cameras and L
    landmarks — the same rule as the JAX package."""
    b_bytes = 6 * C * 3 * L * 4
    return "dense" if C <= _DENSE_SCHUR_MAX_CAMS and b_bytes <= _DENSE_B_MAX_BYTES else "pcg"


def _lm_update(ok, new, old):
    return tuple(torch.where(ok, n, o) for n, o in zip(new, old))


def _run_loop(body, state, max_iters: int, loop: str, done_index: int):
    """LM iterations: loop="while" stops once the state's `done` flag is set
    (one host read per iteration), "unrolled" runs exactly max_iters."""
    if loop not in ("while", "unrolled"):
        raise ValueError(f"unknown loop mode {loop!r}")
    for _ in range(max_iters):
        state = body(state)
        if loop == "while" and _sync_bool(state[done_index]):
            break
    return state


@f32_matmuls
def ba_solve(
    problem: BAProblem,
    max_iters: int = 30,
    huber_delta_px: float = 4.0,
    lam0: float = 1e-4,
    lam_up: float = 4.0,
    lam_down: float = 0.25,
    rtol: float = 1e-6,
    solver: str = "auto",
    cg_iters: int = 100,
    cg_tol: float = 1e-2,
    loop: str = "while",
) -> BAResult:
    """Levenberg-Marquardt over poses and points.

    solver: "dense" (explicit 6Cx6C Cholesky), "pcg" (matrix-free
    preconditioned CG — O(K*L) memory, for large scenes), or "auto" (by
    camera count and elimination-factor size, `_auto_solver`).
    loop: "while" (early exit once the relative cost decrease of an accepted
    step falls below rtol; one host read per iteration, and one per CG
    iteration) or "unrolled" (exactly max_iters iterations, the CG exactly
    cg_iters with convergence masking; no host reads)."""
    return _lm_solve(problem, max_iters, huber_delta_px, lam0, lam_up, lam_down, rtol, solver,
                     cg_iters, cg_tol, loop)


def _lm_solve(problem, max_iters, huber_delta_px, lam0, lam_up, lam_down, rtol, solver, cg_iters,
              cg_tol, loop, reduce=None, n_landmarks=None) -> BAResult:
    """ba_solve's LM loop. With `reduce` (a sum across ranks) `problem`
    holds this rank's block of the landmarks (`parallel/ba_sharded.py`):
    the costs and the camera-sized Schur sums are summed across ranks, so
    every rank takes the same steps and leaves the loops together, and
    "auto" picks the solver for `n_landmarks`, the landmarks of all
    ranks."""
    C = problem.cam_q.shape[0]
    L = problem.points.shape[0] if n_landmarks is None else n_landmarks
    if solver == "auto":
        solver = _auto_solver(C, L)
    if solver == "dense":
        schur = lambda *a, x_warm=None: _schur_solve(*a, reduce=reduce)  # noqa: E731
    elif solver == "pcg":
        cg_loop = "while" if loop == "while" else "fori"
        schur = lambda *a, x_warm=None: _schur_solve_pcg(  # noqa: E731
            *a, cg_iters=cg_iters, cg_tol=cg_tol, loop=cg_loop, x_warm=x_warm, reduce=reduce
        )
    else:
        raise ValueError(f"unknown solver {solver!r}")

    dev = problem.cam_c.device
    huber = torch.full((), huber_delta_px, dtype=torch.float32, device=dev)
    cost0 = _cost(problem, problem.cam_q, problem.cam_c, problem.points, huber, reduce)

    def body(state):
        q, c, X, lam, cost, it, done, dxp = state
        r, Jc, Jl = _residuals_and_jacobians(problem, q, c, X)  # obs-minor
        w = _irls_weights(problem, r, huber)
        dx_cam, dx_pt = schur(problem, r * w, Jc * w, Jl * w, lam, x_warm=dxp)

        q_new = _quat_premul_mat(so3_exp(dx_cam[:, 0:3]), q)
        c_new = c + dx_cam[:, 3:6]
        X_new = X + dx_pt

        new_cost = _cost(problem, q_new, c_new, X_new, huber, reduce)
        ok = torch.isfinite(new_cost) & (new_cost < cost)
        q, c, X = _lm_update(ok, (q_new, c_new, X_new), (q, c, X))
        lam = torch.clamp(torch.where(ok, lam * lam_down, lam * lam_up), 1e-12, 1e8)
        improved = torch.where(ok, (cost - new_cost) / cost.clamp(min=_EPS), 1.0)
        done = done | (ok & (improved < rtol))
        cost = torch.where(ok, new_cost, cost)
        return (q, c, X, lam, cost, it + 1, done, dx_cam)

    state0 = (
        problem.cam_q,
        problem.cam_c,
        problem.points,
        torch.full((), lam0, dtype=torch.float32, device=dev),
        cost0,
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.bool, device=dev),
        torch.zeros((C, 6), dtype=problem.cam_c.dtype, device=dev),
    )
    q, c, X, lam, cost, it, *_ = _run_loop(body, state0, max_iters, loop, done_index=6)
    return BAResult(cam_q=q, cam_c=c, points=X, cost_initial=cost0, cost_final=cost, n_iters=it)


class JointBAResult(NamedTuple):
    cam_q: torch.Tensor
    cam_c: torch.Tensor
    points: torch.Tensor
    intr: cam.Intrinsics
    cost_initial: torch.Tensor
    cost_final: torch.Tensor
    n_iters: torch.Tensor


@f32_matmuls
def ba_solve_joint(
    problem: BAProblem,
    max_iters: int = 20,
    huber_delta_px: float = 4.0,
    lam0: float = 1e-4,
    lam_up: float = 4.0,
    lam_down: float = 0.25,
    rtol: float = 1e-6,
    refine_focal: bool = True,
    refine_pp: bool = True,
    refine_disto: bool = True,
    disto_max_order: int | None = None,
    loop: str = "while",
    param_mask=None,
) -> JointBAResult:
    """LM over poses + points + SHARED intrinsics in one Schur problem (the
    reference's semantics: Ceres refines intrinsics inside every BA,
    BundleAdjustment.hpp REFINE_INTRINSICS_*). Dense reduced solve only.

    param_mask: optional (4 + DISTO_PARAMS,) float gate over the packed
    parameter slots [fx, fy, cx, cy, disto...] — a masked slot's step is
    exactly 0."""
    idx = []
    if refine_focal:
        idx += [0, 1]
    if refine_pp:
        idx += [2, 3]
    if refine_disto:
        n_d = cam.DISTO_PARAMS if disto_max_order is None else min(disto_max_order, cam.DISTO_PARAMS)
        idx += [4 + i for i in range(n_d)]
    intr_param_idx = tuple(idx)
    if not intr_param_idx:
        raise ValueError("nothing selected to refine — use ba_solve")
    dev = problem.cam_c.device
    I = problem.intr.scale.shape[0]
    n_p = 4 + cam.DISTO_PARAMS
    # scatter map from the packed P-vector back to (I, n_p)
    rows = torch.from_numpy(np.repeat(np.arange(I), len(intr_param_idx))).to(dev)
    cols = torch.from_numpy(np.tile(np.array(intr_param_idx), I)).to(dev)
    colmask = None if param_mask is None else torch.as_tensor(
        np.asarray(param_mask), dtype=torch.float32, device=dev
    )[cols]

    huber = torch.full((), huber_delta_px, dtype=torch.float32, device=dev)
    cost0 = _cost(problem, problem.cam_q, problem.cam_c, problem.points, huber)

    def body(state):
        q, c, X, dt, lam, cost, it, done = state
        r, Jc, Jl, Jt = _residuals_and_jacobians(problem, q, c, X, dtheta=dt, intr_param_idx=intr_param_idx)
        w = _irls_weights(problem, r, huber)
        dx_cam, dx_pt, dth = _schur_solve_joint(problem, r * w, Jc * w, Jl * w, Jt * w, lam, colmask=colmask)
        q_new = _quat_premul_mat(so3_exp(dx_cam[:, 0:3]), q)
        c_new = c + dx_cam[:, 3:6]
        X_new = X + dx_pt
        dt_new = dt.index_put((rows, cols), dth, accumulate=True)

        rr = _residuals(problem, q_new, c_new, X_new, intr=_intr_apply(problem.intr, dt_new))
        new_cost = _robust_cost(problem, rr, huber)
        ok = torch.isfinite(new_cost) & (new_cost < cost)
        q, c, X, dt = _lm_update(ok, (q_new, c_new, X_new, dt_new), (q, c, X, dt))
        lam = torch.clamp(torch.where(ok, lam * lam_down, lam * lam_up), 1e-12, 1e8)
        improved = torch.where(ok, (cost - new_cost) / cost.clamp(min=_EPS), 1.0)
        done = done | (ok & (improved < rtol))
        cost = torch.where(ok, new_cost, cost)
        return (q, c, X, dt, lam, cost, it + 1, done)

    state0 = (
        problem.cam_q, problem.cam_c, problem.points,
        torch.zeros((I, n_p), dtype=torch.float32, device=dev),
        torch.full((), lam0, dtype=torch.float32, device=dev), cost0,
        torch.zeros((), dtype=torch.int32, device=dev), torch.zeros((), dtype=torch.bool, device=dev),
    )
    q, c, X, dt, lam, cost, it, _ = _run_loop(
        body, state0, max_iters, "while" if loop == "while" else "unrolled", done_index=7
    )
    return JointBAResult(
        cam_q=q, cam_c=c, points=X, intr=_intr_apply(problem.intr, dt),
        cost_initial=cost0, cost_final=cost, n_iters=it,
    )


def _gauss_newton(residuals, dp, iters: int):
    """`iters` Gauss-Newton steps on the parameter tensor dp, each kept only
    if it lowers the sum of squared residuals. The Jacobian comes from
    forward mode over the parameter basis (`torch.func.jacfwd`)."""
    n = dp.numel()
    eye = torch.eye(n, dtype=dp.dtype, device=dp.device)
    for _ in range(iters):
        r = residuals(dp)
        J = torch.func.jacfwd(residuals)(dp).reshape(r.numel(), n).T  # (n, n_res)
        JtJ = J @ J.T + 1e-6 * eye
        step = -torch.linalg.solve_ex(JtJ, J @ r)[0].reshape(dp.shape)
        new = dp + step
        better = torch.sum(residuals(new) ** 2) < torch.sum(r * r)
        dp = torch.where(better, new, dp)
    return dp


@f32_matmuls
def refine_intrinsics(
    problem: BAProblem,
    cam_q,
    cam_c,
    points,
    refine_focal: bool = True,
    refine_pp: bool = True,
    refine_disto: bool = True,
    iters: int = 10,
    disto_max_order: int | None = None,
) -> cam.Intrinsics:
    """Gauss-Newton refinement of the intrinsic table with poses/points held
    (the alternating counterpart of the reference's REFINE_INTRINSICS_*).
    Returns the refined Intrinsics."""
    intr = problem.intr
    dev = cam_c.device
    I = intr.scale.shape[0]
    # parameter packing: [d_fx, d_fy, d_cx, d_cy, d_disto(6)] per intrinsic
    n_p = 4 + cam.DISTO_PARAMS
    sel = np.zeros(n_p, np.float32)
    if refine_focal:
        sel[0:2] = 1
    if refine_pp:
        sel[2:4] = 1
    if refine_disto:
        if disto_max_order is None:
            sel[4:] = 1
        else:
            # coarse-to-fine: with thin support only the low-order radial
            # terms are observable
            sel[4: 4 + max(disto_max_order, 0)] = 1
    sel = torch.from_numpy(sel).to(dev)

    Rm = quat_to_mat(cam_q)[problem.obs_cam]
    c = cam_c[problem.obs_cam]
    X = points[:, None, :].expand(c.shape)
    x_cam = torch.einsum("lkij,lkj->lki", Rm, X - c)
    m = problem.obs_mask.to(x_cam.dtype)

    def apply_delta(dp):
        return _intr_apply(intr, dp * sel[None, :])

    def residuals(dp):
        pix = cam.project_cam(_intr_rows(apply_delta(dp), problem.obs_intr), x_cam)
        return ((pix - problem.obs_uv) * m[..., None]).reshape(-1)

    dp = _gauss_newton(residuals, torch.zeros((I, n_p), dtype=torch.float32, device=dev), iters)
    return apply_delta(dp)


def _pcg_columns(S_apply, M_apply, E, cg_iters: int):
    """cg_iters fixed PCG iterations of (S + 1e-6 I) X = E for a batch of
    right-hand sides E (B, C, 6), each column with its own step sizes."""
    def dot(a, b):
        return torch.sum(a * b, dim=(-2, -1))[:, None, None]

    x = torch.zeros_like(E)
    res = E
    z = M_apply(E)
    p = z
    for _ in range(cg_iters):
        Sp = S_apply(p) + 1e-6 * p
        rz = dot(res, z)
        alpha = rz / dot(p, Sp).clamp(min=_EPS)
        x = x + alpha * p
        res = res - alpha * Sp
        z_n = M_apply(res)
        beta = dot(res, z_n) / rz.clamp(min=_EPS)
        z = z_n
        p = p * beta + z_n
    return x


# Elements of the (B, 6, 3, K, L) matvec temporaries that one batch of
# covariance column solves may hold (1 GiB of float32).
_COV_BATCH_ELEMENTS = 1 << 28


@f32_matmuls
def pose_covariances_pcg(problem: BAProblem, cam_q, cam_c, points, cam_indices=None,
                         cg_iters: int = 200) -> torch.Tensor:
    """Memory-light covariance: diagonal blocks of S^-1 by matrix-free PCG
    column solves, 6 per requested camera, O(K*L) memory regardless of the
    camera count. The columns of several cameras run as one multi-right-hand
    -side CG (the same fixed-count arithmetic per column). Returns
    (len(cam_indices), 6, 6)."""
    C = cam_q.shape[0]
    L, K = problem.obs_mask.shape
    dev = cam_c.device
    if cam_indices is None:
        cam_indices = range(C)
    cams = [int(i) for i in (cam_indices.tolist() if hasattr(cam_indices, "tolist") else cam_indices)]

    r, Jc, Jl = _residuals_and_jacobians(problem, cam_q, cam_c, points)
    mT = problem.obs_mask.T.to(r.dtype)
    parts = _schur_prelude(problem, r, Jc, Jl, torch.zeros((), device=dev))
    S_apply, M_apply = _s_operator(parts, C, r.dtype)

    per_batch = max(1, _COV_BATCH_ELEMENTS // (6 * 18 * K * L))  # cameras a batch
    blocks = []
    for s in range(0, len(cams), per_batch):
        chunk = cams[s: s + per_batch]
        B = 6 * len(chunk)
        ci = torch.tensor(chunk, device=dev).repeat_interleave(6)
        cj = torch.arange(6, device=dev).repeat(len(chunk))
        E = torch.zeros((B, C, 6), dtype=r.dtype, device=dev)
        E[torch.arange(B, device=dev), ci, cj] = 1.0
        X = _pcg_columns(S_apply, M_apply, E, cg_iters)
        cols = X[torch.arange(B, device=dev), ci]  # (B, 6): column j of camera ci
        blocks.append(cols.reshape(len(chunk), 6, 6).transpose(1, 2))
    blocks = torch.cat(blocks)
    n_obs = torch.sum(problem.obs_mask)
    dof = torch.clamp(2.0 * n_obs - 6.0 * C - 3.0 * L, min=1.0)
    sigma2 = torch.sum((r * mT) ** 2) / dof
    return sigma2 * 0.5 * (blocks + blocks.transpose(-1, -2))


@f32_matmuls
def pose_covariances(problem: BAProblem, cam_q, cam_c, points) -> torch.Tensor:
    """Per-camera 6x6 pose covariance from the (undamped) reduced camera
    system: diagonal blocks of S^-1 scaled by the residual variance (ref:
    src/software/utils/main_computeUncertainty.cpp). Returns (C, 6, 6).
    Dense (C, C, 6, 6) assembly — use `pose_covariances_pcg` past ~2000
    cameras."""
    r, Jc, Jl = _residuals_and_jacobians(problem, cam_q, cam_c, points)
    # landmark-major block algebra on this cold path
    r = r.permute(2, 1, 0)  # (L, K, 2)
    Jc = Jc.permute(3, 2, 0, 1)  # (L, K, 2, 6)
    Jl = Jl.permute(3, 2, 0, 1)  # (L, K, 2, 3)
    m = problem.obs_mask
    C = cam_q.shape[0]
    L, K = m.shape
    dev = r.device

    Jc = Jc * (~problem.cam_fixed)[problem.obs_cam][..., None, None]
    Jl = Jl * (~problem.point_fixed)[:, None, None, None]
    Jc = Jc * m.to(r.dtype)[..., None, None]
    Jl = Jl * m.to(r.dtype)[..., None, None]

    V = torch.einsum("lkri,lkrj->lij", Jl, Jl) + 1e-8 * torch.eye(3, device=dev)
    W = torch.einsum("lkri,lkrj->lkij", Jc, Jl)
    Uc_blk = torch.einsum("lkri,lkrj->lkij", Jc, Jc)
    U = torch.zeros((C, 6, 6), dtype=r.dtype, device=dev)
    U.index_add_(0, problem.obs_cam.reshape(-1), Uc_blk.reshape(-1, 6, 6))

    V_inv = _sym3_inv(V)
    Y = torch.einsum("lkij,ljh->lkih", W, V_inv)
    pair = torch.einsum("lkih,lmjh->lkmij", Y, W)
    oc = problem.obs_cam.long()
    ci = oc[:, :, None].expand(L, K, K).reshape(-1)
    cj = oc[:, None, :].expand(L, K, K).reshape(-1)
    S = torch.zeros((C * C, 6, 6), dtype=r.dtype, device=dev)
    S.index_add_(0, ci * C + cj, -pair.reshape(-1, 6, 6))
    S = S.reshape(C, C, 6, 6)
    ar = torch.arange(C, device=dev)
    S[ar, ar] += U
    S_mat = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
    # fixed cameras have empty rows — regularize so the inverse exists (fix
    # >= 1 pose for meaningful absolute covariances)
    S_mat = S_mat + 1e-6 * torch.eye(C * 6, dtype=r.dtype, device=dev)
    S_inv = torch.linalg.inv_ex(S_mat)[0]
    S_inv = 0.5 * (S_inv + S_inv.T)  # enforce symmetry lost to f32

    # residual variance (2 dof per obs, 6C + 3L params)
    n_obs = torch.sum(m)
    dof = torch.clamp(2.0 * n_obs - 6.0 * C - 3.0 * L, min=1.0)
    sigma2 = torch.sum((r * m[..., None]) ** 2) / dof
    blocks = S_inv.reshape(C, 6, C, 6)
    return sigma2 * blocks[ar, :, ar, :]


@f32_matmuls
def refine_rig_subposes(problem: BAProblem, cam_q, cam_c, points, iters: int = 8,
                        huber_delta_px: float = 4.0) -> tuple:
    """Gauss-Newton refinement of the rig sub-poses with frames/points held
    (the alternating half of rig_solve). Sub-pose 0 is the identity and is
    never moved. Returns (sub_q, sub_t)."""
    if problem.sub_q is None:
        raise ValueError("problem has no rig sub-poses")
    S = problem.sub_q.shape[0]
    dev = cam_c.device
    huber = torch.full((), huber_delta_px, dtype=torch.float32, device=dev)
    live = torch.ones((S,), dtype=problem.sub_t.dtype, device=dev)
    live[0] = 0.0  # freeze identity sub-pose 0

    def params_to_subs(dp):  # dp (S, 6) tangent
        dp = dp * live[:, None]
        return _quat_premul_mat(so3_exp(dp[:, :3]), problem.sub_q), problem.sub_t + dp[:, 3:]

    def residuals(dp):
        sq, st = params_to_subs(dp)
        r = _residuals(problem, cam_q, cam_c, points, sub_q=sq, sub_t=st)
        return (r * _irls_weights(problem, r, huber)).reshape(-1)

    dp = _gauss_newton(residuals, torch.zeros((S, 6), dtype=problem.sub_t.dtype, device=dev), iters)
    return params_to_subs(dp)


def rig_solve(problem: BAProblem, rounds: int = 10, max_iters: int = 15, solver: str = "auto") -> tuple:
    """Alternating rig bundle adjustment: frame poses + points via the Schur
    LM (sub-poses held), then sub-pose GN (frames/points held), repeated.
    Returns (BAResult, sub_q, sub_t)."""
    if problem.sub_q is None:
        raise ValueError("problem has no rig sub-poses")
    for _ in range(rounds):
        res = ba_solve(problem, max_iters=max_iters, solver=solver)
        problem = problem._replace(cam_q=res.cam_q, cam_c=res.cam_c, points=res.points)
        sq, st = refine_rig_subposes(problem, res.cam_q, res.cam_c, res.points)
        problem = problem._replace(sub_q=sq, sub_t=st)
    res = ba_solve(problem, max_iters=max_iters, solver=solver)
    return res, problem.sub_q, problem.sub_t


def rms_reprojection_error(problem: BAProblem, cam_q, cam_c, points) -> torch.Tensor:
    r = _residuals(problem, cam_q, cam_c, points)  # (2, K, L)
    sq = r[0] * r[0] + r[1] * r[1]
    m = problem.obs_mask.T
    return torch.sqrt(torch.sum(torch.where(m, sq, 0.0)) / torch.sum(m).clamp(min=1))
