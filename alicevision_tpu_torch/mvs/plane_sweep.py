"""Plane-sweep similarity volumes + SGM depth estimation.

Port of `alicevision_tpu/mvs/plane_sweep.py` (ref:
src/aliceVision/depthMap/Sgm.cpp:117-158 sgmRc pipeline,
cuda/planeSweeping/deviceSimilarityVolumeKernels.cuh:109-235 similarity,
:658-726 SGM aggregation, :393-515 best-depth retrieval; SgmParams.hpp:17-55
defaults).

For every (depth, tcam) the T-cam image is warped into the reference view
through the fronto-parallel plane homography, and windowed ZNCC between
reference and warp is computed with separable Gaussian moments. SGM cost
aggregation is the 4-direction dynamic program with the image-gradient
adaptive P2 of the reference. Each axis's two directional sweeps go through
`ops/sgm_kernel.sgm_axis_sweeps`: the hand-written CUDA kernel for a tensor
on the card, the plain `_axis_sweeps` below (over `_directional_pass`) for
one on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..image.filtering import gaussian_blur
from ..ops.sgm_kernel import sgm_axis_sweeps

_EPS = 1e-6


class SgmParams(NamedTuple):
    n_depths: int = 128
    sigma_window: float = 2.0  # Gaussian window of the ZNCC (≈ wsh=4 box)
    p1: float = 10.0
    p2_weight: float = 100.0
    p2_alpha: float = 10.0  # gradient adaptivity of P2 (deviceSimilarityVolumeKernels.cuh:597-656)
    cost_clip: float = 1.0  # similarity in [-1, 1] -> cost in [0, cost_clip*255]
    depth_chunk: int = 8  # depth planes evaluated together (memory knob)
    # similarity-volume builder: "auto" gates per (ref, tcam) pair on
    # rectifiability (host-side) and uses the gather-free rectified sweep
    # where valid; "gather" / "rectified" force one path.
    method: str = "auto"
    rect_depth_chunk: int = 64  # planes per chunk of the rectified sweep
    # edge-aware cost aggregation (guided filter of the cost volume);
    # 0 disables. Ported with ops/guided_filter.py in a later slice.
    guided_radius: int = 0
    guided_eps: float = 1e-3
    # 4 = the reference's default "YX" axes both ways (SgmParams.hpp:34);
    # 8 adds the four diagonal paths (classic Hirschmuller SGM).
    n_dirs: int = 4


def inverse_depth_planes(d_min: float, d_max: float, n: int, device=None) -> torch.Tensor:
    """Plane depths sampled uniformly in inverse depth (SgmDepthList.cpp)."""
    inv = torch.linspace(1.0 / d_max, 1.0 / d_min, n, dtype=torch.float32, device=device)
    return 1.0 / inv.flip(0)  # ascending depth


def plane_homography(K_ref, K_t, R_rel, t_rel, depth):
    """Homography mapping reference pixels -> T-cam pixels for the
    fronto-parallel plane at `depth` (n = [0,0,1] in the ref frame).

    H = K_t (R + t n^T / d) K_ref^-1 with (R, t) = pose of tcam in ref frame.
    """
    n = torch.tensor([0.0, 0.0, 1.0], dtype=R_rel.dtype, device=R_rel.device)
    H = R_rel + torch.outer(t_rel, n) / depth
    return K_t @ H @ torch.linalg.inv(K_ref)


def _pixel_grid(h: int, w: int, dtype, device) -> torch.Tensor:
    """(h, w, 3) homogeneous pixel coordinates (x, y, 1)."""
    ys = torch.arange(h, dtype=dtype, device=device)
    xs = torch.arange(w, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)


def _bilinear_taps(flat, off, vi, ui, fu, fv, h, w):
    """Sum of the four bilinear taps of `flat` at integer corners (vi, ui)
    with fractions (fu, fv); out-of-image taps drop out. Returns the
    normalized value and the total in-image weight."""

    def tap(yi, xi, wt):
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        lin = off + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        val = flat.index_select(0, lin.reshape(-1)).reshape(lin.shape)
        zero = torch.zeros((), dtype=val.dtype, device=val.device)
        return torch.where(ok, val * wt, zero), torch.where(ok, wt, zero)

    a0, w0 = tap(vi, ui, (1 - fu) * (1 - fv))
    a1, w1 = tap(vi, ui + 1, fu * (1 - fv))
    a2, w2 = tap(vi + 1, ui, (1 - fu) * fv)
    a3, w3 = tap(vi + 1, ui + 1, fu * fv)
    wsum = w0 + w1 + w2 + w3
    return (a0 + a1 + a2 + a3) / torch.clamp(wsum, min=_EPS), wsum


def _dehomogenize(q):
    z = q[..., 2]
    zs = torch.where(torch.abs(z) < _EPS, torch.full_like(z, _EPS), z)
    return q[..., 0] / zs, q[..., 1] / zs, z


def warp_homography(img: torch.Tensor, H: torch.Tensor, out_hw):
    """Inverse-warp: sample img at H @ (x, y, 1) for each output pixel."""
    Hh, Ww = out_hw
    p = _pixel_grid(Hh, Ww, torch.float32, img.device)
    q = torch.einsum("ij,hwj->hwi", H, p)
    u, v, z = _dehomogenize(q)
    H_im, W_im = img.shape
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    out, wsum = _bilinear_taps(
        img.reshape(-1), 0, v0.long(), u0.long(), u - u0, v - v0, H_im, W_im
    )
    valid = (wsum > 0.99) & (z > _EPS)
    return torch.where(valid, out, torch.zeros_like(out)), valid


def zncc(ref: torch.Tensor, warp: torch.Tensor, valid: torch.Tensor, sigma: float):
    """Windowed zero-mean NCC between two images via Gaussian moments
    (the separable-filter equivalent of the CUDA per-patch loop,
    Patch.cuh:467-531)."""
    w = valid.to(ref.dtype)

    def blur(x):
        return gaussian_blur(x, sigma)

    cov = blur(w)  # coverage fraction
    wsum = cov.clamp(min=1e-4)
    mr = blur(ref * w) / wsum
    mt = blur(warp * w) / wsum
    rr = blur(ref * ref * w) / wsum - mr * mr
    tt = blur(warp * warp * w) / wsum - mt * mt
    rt = blur(ref * warp * w) / wsum - mr * mt
    den = torch.sqrt(torch.clamp(rr * tt, min=_EPS))
    ncc = rt / den
    return torch.where(cov > 0.5, torch.clamp(ncc, -1.0, 1.0), torch.full_like(ncc, -1.0))


def similarity_volume(
    ref_img: torch.Tensor,  # (H, W) grayscale/luma
    t_imgs: torch.Tensor,  # (T, H, W)
    K_ref: torch.Tensor,  # (3, 3)
    K_t: torch.Tensor,  # (T, 3, 3)
    R_rel: torch.Tensor,  # (T, 3, 3) tcam pose in ref frame
    t_rel: torch.Tensor,  # (T, 3)
    depths: torch.Tensor,  # (D,)
    params: SgmParams = SgmParams(),
    tc_depth_ranges: torch.Tensor | None = None,  # (T, 2) per-tcam [lo, hi]
) -> torch.Tensor:
    """Cost volume (D, H, W) from the mean ZNCC across T-cams per depth
    plane (the gather path). All (depth, tcam) warps of a chunk of
    `params.depth_chunk` planes are one flat index_select per bilinear tap
    over the concatenated T-cam images. Cost convention matches the
    reference (0 good .. 255 bad)."""
    Hh, Ww = ref_img.shape
    T, Ht, Wt = t_imgs.shape  # T-cam dims may differ from the ref (tiling)
    D = depths.shape[0]
    dev, dt = ref_img.device, ref_img.dtype
    flat_imgs = t_imgs.reshape(-1)

    Kinv = torch.linalg.inv(K_ref)
    pix = _pixel_grid(Hh, Ww, dt, dev)  # (H, W, 3)
    rays = torch.einsum("ij,hwj->hwi", Kinv, pix)  # K_ref^-1 p, depth-free

    # Per-tcam homography pieces: H(d) = K_t R K^-1 + (K_t t) (n^T K^-1) / d
    A = torch.einsum("tij,tjk,kl->til", K_t, R_rel, Kinv)  # (T, 3, 3)
    b = torch.einsum("tij,tj->ti", K_t, t_rel)  # (T, 3)
    base = torch.einsum("til,hwl->thwi", A, pix)  # (T, H, W, 3)
    scale = rays[..., 2][None, None, :, :, None]  # z-component of K^-1 p
    t_off = (torch.arange(T, device=dev) * (Ht * Wt))[None, :, None, None]
    lim = None
    if tc_depth_ranges is not None:
        lim = torch.as_tensor(tc_depth_ranges, dtype=depths.dtype, device=dev)

    sims = []
    ch = max(1, min(params.depth_chunk, D))
    for s in range(0, D, ch):
        depth_chunk = depths[s : s + ch]
        C = depth_chunk.shape[0]
        q = (
            base[None]
            + b[None, :, None, None, :] * scale / depth_chunk[:, None, None, None, None]
        )  # (C, T, H, W, 3)
        u, v, z = _dehomogenize(q)
        u0 = torch.floor(u)
        v0 = torch.floor(v)
        warp, wsum = _bilinear_taps(
            flat_imgs, t_off, v0.long(), u0.long(), u - u0, v - v0, Ht, Wt
        )
        valid = (wsum > 0.99) & (z > _EPS)
        if lim is not None:
            # per-T-cam depth sub-range (SgmDepthList depthsTcLimits):
            # planes outside a tcam's meaningful range contribute nothing
            in_lim = (depth_chunk[:, None] >= lim[None, :, 0]) & (
                depth_chunk[:, None] <= lim[None, :, 1]
            )  # (C, T)
            valid = valid & in_lim[..., None, None]
        warp = torch.where(valid, warp, torch.zeros_like(warp))

        # ZNCC of the whole (C*T, H, W) stack against the broadcast ref.
        refb = ref_img.expand(C, T, Hh, Ww)
        sim_ct = zncc(refb, warp, valid, params.sigma_window)  # (C, T, H, W)
        oks = valid.any(dim=-1).any(dim=-1)  # (C, T)
        cnt = oks.sum(dim=-1)  # (C,)
        sims.append(
            torch.sum(sim_ct * oks[..., None, None], dim=1)
            / torch.clamp(cnt[:, None, None], min=1)
        )
    sim = torch.cat(sims)
    # similarity [-1, 1] -> cost [0, 255] (reference stores unsigned cost)
    return (1.0 - sim) * 0.5 * 255.0


# ---------------------------------------------------------------------------
# SGM aggregation
# ---------------------------------------------------------------------------


def _sgm_step(L_prev, C, P2, p1: float):
    m = torch.amin(L_prev, dim=-1, keepdim=True)  # (N, 1)
    up = torch.cat([L_prev[:, :1], L_prev[:, :-1]], dim=1)
    dn = torch.cat([L_prev[:, 1:], L_prev[:, -1:]], dim=1)
    best = torch.minimum(
        torch.minimum(L_prev, torch.minimum(up, dn) + p1), m + P2[:, None]
    )
    return C + best - m


def _directional_pass(cost: torch.Tensor, p2_img: torch.Tensor, p1: float):
    """One forward SGM sweep along axis 0 of cost (S, N, D) with per-position
    adaptive P2 (S, N). Returns aggregated costs of the same shape. The plain
    version of the CUDA kernel in csrc/sgm_directional.cu.

    Recurrence (vectorized over N and D, looped over S):
      L_s = C_s + min(L_{s-1}, L_{s-1}(d+-1) + P1, min_d L_{s-1} + P2) - min_d L_{s-1}
    """
    out = torch.empty_like(cost)
    L = cost[0]
    out[0] = L
    for s in range(1, cost.shape[0]):
        L = _sgm_step(L, cost[s], p2_img[s], p1)
        out[s] = L
    return out


def _diagonal_pass(cost: torch.Tensor, p2_img: torch.Tensor, p1: float, shift: int):
    """Diagonal SGM sweep over rows of cost (H, N, D): position x of row y
    chains to position x-shift of row y-1 (shift = +1 -> down-right path).
    Same recurrence as _directional_pass with the carry row displaced."""

    def move(L):  # displace the previous row along x (edge replicate)
        if shift == 1:
            return torch.cat([L[:1], L[:-1]], dim=0)
        return torch.cat([L[1:], L[-1:]], dim=0)

    out = torch.empty_like(cost)
    L = cost[0]
    out[0] = L
    for s in range(1, cost.shape[0]):
        L = _sgm_step(move(L), cost[s], p2_img[s], p1)
        out[s] = L
    return out


def _axis_sweeps(vol, p2_img, p1: float, axis: int, total=None):
    """Forward and backward SGM sweeps along `axis` (0: H, 1: W) of vol
    (H, W, D), or (B, H, W, D) one view at a time, with per-position P2
    p2_img (vol's shape without D). Adds the forward, then the backward
    sweep into `total` in place, or returns fwd + bwd when total is None.
    Opposite directions are stacked on the row axis of one
    `_directional_pass`. The plain version of
    ops/sgm_kernel.sgm_axis_sweeps, whose kernel walks the same chains by
    index."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 (H) or 1 (W), got {axis}")
    if vol.dim() == 4:
        if total is None:
            return torch.stack([_axis_sweeps(v, p, p1, axis) for v, p in zip(vol, p2_img)])
        for v, p, t in zip(vol, p2_img, total):
            _axis_sweeps(v, p, p1, axis, t)
        return total
    c, p = (vol.transpose(0, 1), p2_img.T) if axis == 1 else (vol, p2_img)
    N = c.shape[1]
    both = _directional_pass(torch.cat([c, c.flip(0)], dim=1), torch.cat([p, p.flip(0)], dim=1), p1)
    fwd, bwd = both[:, :N], both.flip(0)[:, N:]
    if axis == 1:
        fwd, bwd = fwd.transpose(0, 1), bwd.transpose(0, 1)
    if total is None:
        return fwd + bwd
    return total.add_(fwd).add_(bwd)


def sgm_aggregate(
    cost: torch.Tensor,  # (D, H, W)
    ref_img: torch.Tensor,  # (H, W) for gradient-adaptive P2
    params: SgmParams = SgmParams(),
) -> torch.Tensor:
    """4-direction SGM (left/right/up/down), the reference's "YX" both ways,
    plus the four diagonals when params.n_dirs >= 8 (plain torch only).

    The running total is ((right + left) + down) + up, the reference's
    order. Each axis's two sweeps are one `sgm_axis_sweeps` call: on the
    card the kernel walks the (H, W, D) volume by index, so the transpose
    below is the only copy of the volume; on the CPU the plain version
    stacks each pair on the row axis of one directional pass."""
    vol = cost.permute(1, 2, 0)  # (H, W, D)
    if vol.device.type != "cpu":  # the kernel's layout: D innermost
        vol = vol.contiguous()

    # Adaptive P2: large in flat areas, small across strong gradients
    # (deviceSimilarityVolumeKernels.cuh:597-656 uses grad-based weighting).
    gx = torch.abs(torch.roll(ref_img, -1, 1) - ref_img)
    gy = torch.abs(torch.roll(ref_img, -1, 0) - ref_img)

    def p2_of(grad):
        return params.p1 + (params.p2_weight - params.p1) * torch.exp(
            -params.p2_alpha * grad
        )

    p1 = params.p1
    W = ref_img.shape[1]
    # horizontal sweeps along W, then the vertical ones along H, (H, W, D)
    total = sgm_axis_sweeps(vol, p2_of(gx).contiguous(), p1, axis=1)
    total = sgm_axis_sweeps(vol, p2_of(gy).contiguous(), p1, axis=0, total=total)

    if params.n_dirs >= 8:
        # four diagonal paths, two per sweep (forward + both-axes-flipped)
        gd1 = torch.abs(torch.roll(torch.roll(ref_img, -1, 0), -1, 1) - ref_img)
        gd2 = torch.abs(torch.roll(torch.roll(ref_img, -1, 0), 1, 1) - ref_img)

        def flip_both(a):
            return a.flip(0).flip(1)

        for p2d, shift in ((p2_of(gd1), 1), (p2_of(gd2), -1)):
            # shift +1: down-right + up-left; shift -1: down-left + up-right
            d = _diagonal_pass(
                torch.cat([vol, flip_both(vol)], dim=1),
                torch.cat([p2d, flip_both(p2d)], dim=1),
                p1, shift=shift,
            )
            total = total + d[:, :W] + flip_both(d[:, W:])

    return total.permute(2, 0, 1)  # (D, H, W)


def retrieve_best_depth(
    agg: torch.Tensor,  # (D, H, W) aggregated costs
    depths: torch.Tensor,  # (D,)
):
    """Argmin + parabolic subpixel interpolation in inverse depth
    (ref: volume_retrieveBestDepth_kernel :393-515). Returns (depth map,
    similarity map). torch.argmin returns the first minimum, as jnp.argmin
    does."""
    D = agg.shape[0]
    best = torch.argmin(agg, dim=0)  # (H, W)
    c0 = torch.gather(agg, 0, best[None])[0]

    bm = torch.clamp(best - 1, 0, D - 1)
    bp = torch.clamp(best + 1, 0, D - 1)
    cm = torch.gather(agg, 0, bm[None])[0]
    cp = torch.gather(agg, 0, bp[None])[0]
    denom = cm - 2.0 * c0 + cp
    zero = torch.zeros_like(denom)
    delta = torch.where(torch.abs(denom) > _EPS, 0.5 * (cm - cp) / denom, zero)
    delta = torch.clamp(delta, -0.5, 0.5)
    interior = (best > 0) & (best < D - 1)
    delta = torch.where(interior, delta, zero)

    # interpolate in inverse depth (planes are uniform in 1/d)
    inv = 1.0 / depths
    inv_best = inv[best]
    inv_m = inv[bm]
    inv_p = inv[bp]
    inv_interp = inv_best + delta * torch.where(
        delta >= 0, inv_p - inv_best, inv_best - inv_m
    )
    depth_map = 1.0 / torch.clamp(inv_interp, min=_EPS)
    sim_map = 1.0 - c0 / (0.5 * 255.0)  # back to [-1, 1]
    return depth_map, sim_map


def sgm_depth_map(
    ref_img,
    t_imgs,
    K_ref,
    K_t,
    R_rel,
    t_rel,
    d_min: float,
    d_max: float,
    params: SgmParams = SgmParams(),
    depths=None,
    tc_depth_ranges=None,
):
    """Full SGM pipeline for one reference view (Sgm::sgmRc equivalent), on
    the device of `ref_img`. `depths`/`tc_depth_ranges` override the uniform
    inverse-depth grid with an SfM-seeded per-view list + per-T-cam depth
    sub-ranges (mvs/depth_list.py)."""
    from .rectified import similarity_volume_auto

    if params.guided_radius > 0:
        raise NotImplementedError(
            "guided cost-volume filtering (ops/guided_filter.py) is ported "
            "with the refine slice (ROADMAP queue 1)"
        )
    dev = ref_img.device
    if depths is None:
        depths = inverse_depth_planes(d_min, d_max, params.n_depths, device=dev)
    else:
        depths = torch.as_tensor(depths, dtype=torch.float32, device=dev)
    cost = similarity_volume_auto(
        ref_img, t_imgs, K_ref, K_t, R_rel, t_rel, depths, params,
        tc_depth_ranges=tc_depth_ranges,
    )
    agg = sgm_aggregate(cost, ref_img, params)
    return retrieve_best_depth(agg, depths)
