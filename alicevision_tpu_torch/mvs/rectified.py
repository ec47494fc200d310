"""Gather-free rectified plane sweep — the fast similarity-volume path.

Port of `alicevision_tpu/mvs/rectified.py` (DESIGN.md §6b). For a (ref,
tcam) pair, both views are rotated with the Fusiello rectifying rotation
R_rect whose x-axis is the baseline. For the sweep's fronto-parallel planes
(in the ORIGINAL ref frame, Z_orig = d) the per-plane warp in the rectified
frame is u -> a_d * u + b_{d,v}: AFFINE per row, with a plane-constant scale
a_d = 1 - s_d * r13/fx and a shift linear in the row index (s_d = fx B / d).
That decomposes into

  1. a per-row constant shift — the shift theorem on the rows' real FFT
     (rows transformed once per tcam, phase applied per plane, inverse by
     `torch.fft.irfft`);
  2. a plane-constant rescale — linear interpolation at a_d * u, taken as
     the two non-zero taps of the reference's banded hat matrix.

The ZNCC moments then blur in the rectified frame and one depth-independent
bilinear warp rotates the volume back to the original ref grid.
`rectification_ok` gates near-forward pairs back to the gather path.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..image.filtering import gaussian_blur_mm
from .plane_sweep import SgmParams, _pixel_grid, similarity_volume, warp_homography

_EPS = 1e-9


def fusiello_rectification(K_ref, K_t, R_rel, t_rel):
    """Rectifying rotation + pixel homographies for one (ref, tcam) pair.

    Returns (R_rect, H_ref, H_t, B): R_rect rows are the rectified axes in
    ref-frame coordinates; H_ref maps ORIGINAL ref pixels -> rectified
    pixels, H_t maps tcam pixels -> rectified(-tcam) pixels; B = baseline.
    """
    c2 = -R_rel.T @ t_rel  # tcam center in ref frame
    B = torch.linalg.norm(c2)
    v1 = c2 / torch.clamp(B, min=_EPS)
    z = torch.tensor([0.0, 0.0, 1.0], dtype=K_ref.dtype, device=K_ref.device)
    v2 = torch.linalg.cross(z, v1)
    v2 = v2 / torch.clamp(torch.linalg.norm(v2), min=_EPS)
    v3 = torch.linalg.cross(v1, v2)
    R_rect = torch.stack([v1, v2, v3])  # (3, 3), rows = new axes
    K_rect = K_ref
    H_ref = K_rect @ R_rect @ torch.linalg.inv(K_ref)
    H_t = K_rect @ R_rect @ R_rel.T @ torch.linalg.inv(K_t)
    return R_rect, H_ref, H_t, B


def rectification_ok(R_rel: np.ndarray, t_rel: np.ndarray, max_axial: float = 0.6):
    """Host-side gate: False for near-forward motion where rectification
    degenerates (baseline nearly parallel to the ref view axis)."""
    c2 = -np.asarray(R_rel).T @ np.asarray(t_rel)
    n = np.linalg.norm(c2)
    if n < 1e-9:
        return False
    return abs(c2[2]) / n < max_axial


def _shift_scale_rows(img_f, a, b_rows, W_out):
    """Evaluate f(a_c * u + b_{c,v}) for every plane c and row v.

    img_f: (H, K) rfft of zero-padded rows (pad width Wp = 2 (K - 1)).
    a: (C,) plane scales; b_rows: (C, H) per-row shifts; W_out: width.
    Returns (C, H, W_out)."""
    H, K = img_f.shape
    Wp = 2 * (K - 1)
    k = torch.arange(K, dtype=torch.float32, device=img_f.device)
    # shift theorem: (S_b f)(x) = f(x + b)  <=>  F[k] *= exp(+2i pi k b / Wp)
    phase = torch.exp(2j * math.pi * k * (b_rows[..., None] / Wp))  # (C, H, K)
    shifted = torch.fft.irfft(img_f * phase, n=Wp, dim=-1)  # (C, H, Wp)
    # plane-constant rescale: out[u] = shifted[a * u], linear interpolation
    # with the hat weights max(0, 1 - |src - u_in|) of the reference's
    # banded matrix, evaluated at its only two non-zero columns
    u_out = torch.arange(W_out, dtype=torch.float32, device=img_f.device)
    src = a[:, None] * u_out[None, :]  # (C, W_out)
    i0 = torch.floor(src).long()
    C = src.shape[0]
    out = None
    for ui in (i0, i0 + 1):
        ok = (ui >= 0) & (ui < Wp)
        wt = torch.clamp(1.0 - torch.abs(src - ui.to(src.dtype)), min=0.0)
        wt = torch.where(ok, wt, torch.zeros_like(wt))
        idx = ui.clamp(0, Wp - 1)[:, None, :].expand(C, H, W_out)
        term = torch.gather(shifted, 2, idx) * wt[:, None, :]
        out = term if out is None else out + term
    return out


def _unrectify_volume(vol, H_ref, out_hw, fill):
    """Rotate a (D, Hr, Wr) rectified volume back to the original ref grid.

    The warp is depth-independent, so the gather indices are shared by all
    D planes: one index_select along the pixel axis of the (D, Hr*Wr)
    matrix per bilinear tap."""
    D, Hr, Wr = vol.shape
    Ho, Wo = out_hw
    p = _pixel_grid(Ho, Wo, torch.float32, vol.device)  # (Ho, Wo, 3)
    q = torch.einsum("ij,hwj->hwi", H_ref, p)
    z = q[..., 2]
    zs = torch.where(torch.abs(z) < _EPS, torch.full_like(z, _EPS), z)
    u = q[..., 0] / zs
    v = q[..., 1] / zs

    flat = vol.reshape(D, Hr * Wr)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    u0i = u0.long()
    v0i = v0.long()

    def tap(vi, ui, w):
        ok = (ui >= 0) & (ui < Wr) & (vi >= 0) & (vi < Hr)
        lin = vi.clamp(0, Hr - 1) * Wr + ui.clamp(0, Wr - 1)
        vals = flat.index_select(1, lin.reshape(-1)).reshape(D, Ho, Wo)
        return (
            torch.where(ok, vals * w, fill * w),
            torch.where(ok, w, torch.zeros_like(w)),
        )

    a0, w0 = tap(v0i, u0i, (1 - fu) * (1 - fv))
    a1, w1 = tap(v0i, u0i + 1, fu * (1 - fv))
    a2, w2 = tap(v0i + 1, u0i, (1 - fu) * fv)
    a3, w3 = tap(v0i + 1, u0i + 1, fu * fv)
    wsum = w0 + w1 + w2 + w3
    out = (a0 + a1 + a2 + a3) / torch.clamp(wsum, min=_EPS)
    return torch.where(wsum > 0.99, out, torch.full_like(out, fill))


def pair_similarity_rectified(
    ref_img: torch.Tensor,  # (H, W)
    t_img: torch.Tensor,  # (Ht, Wt)
    K_ref: torch.Tensor,
    K_t: torch.Tensor,
    R_rel: torch.Tensor,
    t_rel: torch.Tensor,
    depths: torch.Tensor,  # (D,)
    params: SgmParams = SgmParams(),
) -> torch.Tensor:
    """ZNCC similarity volume (D, H, W) for ONE tcam, gather-free per depth.
    Returns similarity in [-1, 1] with -1 where invalid."""
    H, W = ref_img.shape
    dev = ref_img.device
    R_rect, H_ref, H_t, B = fusiello_rectification(K_ref, K_t, R_rel, t_rel)

    # one-time rectification warps (the only per-pair image gathers)
    ref_rect, ref_ok = warp_homography(ref_img, torch.linalg.inv(H_ref), (H, W))
    t_rect, t_ok = warp_homography(t_img, torch.linalg.inv(H_t), (H, W))

    fx = K_ref[0, 0]
    fy = K_ref[1, 1]
    cx = K_ref[0, 2]
    cy = K_ref[1, 2]
    alpha = R_rect[0, 2] / fx
    beta = R_rect[1, 2] / fy
    gamma = R_rect[2, 2] - alpha * cx - beta * cy
    s = fx * B / depths  # (D,)
    a = 1.0 - s * alpha  # (D,) plane-constant scales
    rows = torch.arange(H, dtype=torch.float32, device=dev)
    b = -s[:, None] * (beta * rows[None, :] + gamma)  # (D, H) row shifts

    # rows are transformed once; the per-plane work is phase * irfft + taps
    Wp = 2 * W
    t_f = torch.fft.rfft(F.pad(t_rect, (0, Wp - W)), dim=-1)
    # t_rect's valid region is the homography image of a rectangle — one
    # u-interval [lo_v, hi_v] per row; validity of a shifted sample is an
    # analytic comparison
    u_axis = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    inf = torch.tensor(float("inf"), device=dev)
    lo_v = torch.where(t_ok, u_axis, inf).amin(dim=1)  # (H,)
    hi_v = torch.where(t_ok, u_axis, -inf).amax(dim=1)

    # per-pair hoisted reference moments; per plane only the warp-side
    # moments remain, fused into ONE stacked blur of 5 channels
    def blur(x):
        return gaussian_blur_mm(x, params.sigma_window)

    mr = blur(ref_rect)
    rr = torch.clamp(blur(ref_rect * ref_rect) - mr * mr, min=0.0)

    D = depths.shape[0]
    ch = max(1, min(params.rect_depth_chunk, D))
    sims = []
    for s0 in range(0, D, ch):
        a_c = a[s0 : s0 + ch]
        b_c = b[s0 : s0 + ch]
        warped = _shift_scale_rows(t_f, a_c, b_c, W)  # (C, H, W)
        u_src = a_c[:, None, None] * u_axis[None] + b_c[:, :, None]
        valid = (
            (u_src >= lo_v[None, :, None])
            & (u_src <= hi_v[None, :, None] - 1.0)
            & (u_src >= 0.0)
            & (u_src <= W - 1.0)
            & ref_ok[None]
        )
        warps = torch.where(valid, warped, torch.zeros_like(warped))
        w = valid.to(warps.dtype)
        stack = torch.stack(
            [w, warps, warps * warps, ref_rect[None] * warps, ref_rect[None] * w]
        )  # (5, C, H, W) — warps are already zeroed outside validity
        bl = blur(stack)
        wsum = bl[0].clamp(min=1e-4)
        mt = bl[1] / wsum
        tt = bl[2] / wsum - mt * mt
        mr_w = bl[4] / wsum  # validity-masked ref mean for the cross term
        rt = bl[3] / wsum - mr_w * mt
        den = torch.sqrt(torch.clamp(rr[None] * tt, min=1e-6))
        ncc = torch.clamp(rt / den, -1.0, 1.0)
        sims.append(torch.where(bl[0] > 0.5, ncc, torch.full_like(ncc, -1.0)))
    sims_rect = torch.cat(sims)

    # rotate the volume back to the original ref pixel grid
    return _unrectify_volume(sims_rect, H_ref, (H, W), fill=-1.0)


def _apply_tc_range(sim, depths, tc_depth_ranges, t):
    """Mask a per-pair similarity volume outside tcam t's depth sub-range
    (SgmDepthList depthsTcLimits, SgmDepthList.cpp:160-178)."""
    if tc_depth_ranges is None:
        return sim
    lim = torch.as_tensor(tc_depth_ranges, dtype=depths.dtype, device=depths.device)
    in_lim = (depths >= lim[t, 0]) & (depths <= lim[t, 1])  # (D,)
    return torch.where(in_lim[:, None, None], sim, torch.full_like(sim, -1.0))


def _fuse(sims, oks):
    """Mean similarity over the tcams whose slice is usable -> cost."""
    sims = torch.stack(sims)  # (T, D, H, W)
    oks = torch.stack(oks)  # (T, D)
    cnt = torch.sum(oks, dim=0)  # (D,)
    sim = torch.sum(sims * oks[:, :, None, None], dim=0) / torch.clamp(
        cnt[:, None, None], min=1
    )
    return (1.0 - sim) * 0.5 * 255.0


def _usable(sim):
    return (sim > -1.0).any(dim=-1).any(dim=-1)  # (D,) slice usable


def similarity_volume_rectified(
    ref_img: torch.Tensor,
    t_imgs: torch.Tensor,  # (T, Ht, Wt)
    K_ref: torch.Tensor,
    K_t: torch.Tensor,  # (T, 3, 3)
    R_rel: torch.Tensor,  # (T, 3, 3)
    t_rel: torch.Tensor,  # (T, 3)
    depths: torch.Tensor,
    params: SgmParams = SgmParams(),
    tc_depth_ranges=None,
) -> torch.Tensor:
    """Drop-in replacement for plane_sweep.similarity_volume: cost volume
    (D, H, W) in [0, 255], mean ZNCC over tcams."""
    sims, oks = [], []
    for t in range(t_imgs.shape[0]):
        sim = pair_similarity_rectified(
            ref_img, t_imgs[t], K_ref, K_t[t], R_rel[t], t_rel[t], depths, params
        )
        sim = _apply_tc_range(sim, depths, tc_depth_ranges, t)
        sims.append(sim)
        oks.append(_usable(sim))
    return _fuse(sims, oks)


def similarity_volume_auto(
    ref_img: torch.Tensor,
    t_imgs: torch.Tensor,  # (T, Ht, Wt)
    K_ref: torch.Tensor,
    K_t: torch.Tensor,  # (T, 3, 3)
    R_rel: torch.Tensor,  # (T, 3, 3)
    t_rel: torch.Tensor,  # (T, 3)
    depths: torch.Tensor,
    params: SgmParams = SgmParams(),
    tc_depth_ranges=None,
) -> torch.Tensor:
    """Cost volume (D, H, W) with per-pair path selection.

    `params.method` "rectified"/"gather" force a path; "auto" routes each
    (ref, tcam) pair through the rectified sweep when its geometry is
    non-degenerate (`rectification_ok`, on the host: one copy of the poses
    per view) and through the plane-homography gather sweep otherwise, then
    fuses the per-pair ZNCC volumes (ref: src/aliceVision/depthMap/cuda/
    planeSweeping/deviceSimilarityVolumeKernels.cuh:109-235)."""
    args = (ref_img, t_imgs, K_ref, K_t, R_rel, t_rel, depths, params)
    method = params.method
    if method == "gather":
        return similarity_volume(*args, tc_depth_ranges=tc_depth_ranges)
    if method == "rectified":
        return similarity_volume_rectified(*args, tc_depth_ranges=tc_depth_ranges)

    T = t_imgs.shape[0]
    R_np = R_rel.detach().cpu().numpy()
    t_np = t_rel.detach().cpu().numpy()
    ok = [rectification_ok(R_np[t], t_np[t]) for t in range(T)]
    if all(ok):
        return similarity_volume_rectified(*args, tc_depth_ranges=tc_depth_ranges)
    if not any(ok):
        return similarity_volume(*args, tc_depth_ranges=tc_depth_ranges)

    # mixed: fuse per-pair similarity volumes from both paths
    sims, oks = [], []
    for t in range(T):
        if ok[t]:
            sim = pair_similarity_rectified(
                ref_img, t_imgs[t], K_ref, K_t[t], R_rel[t], t_rel[t], depths, params
            )
            sim = _apply_tc_range(sim, depths, tc_depth_ranges, t)
            sims.append(sim)
            oks.append(_usable(sim))
            continue
        cost = similarity_volume(
            ref_img,
            t_imgs[t : t + 1],
            K_ref,
            K_t[t : t + 1],
            R_rel[t : t + 1],
            t_rel[t : t + 1],
            depths,
            params,
        )
        sim = 1.0 - cost / 127.5
        # similarity_volume zeros unusable slices (cost 127.5); a real
        # ZNCC slice is never exactly 0 everywhere
        sim = _apply_tc_range(sim, depths, tc_depth_ranges, t)
        sims.append(sim)
        oks.append(((torch.abs(sim) > 1e-6) & (sim > -0.999)).any(dim=-1).any(dim=-1))
    return _fuse(sims, oks)
