"""AKAZE features: nonlinear diffusion scale space + Hessian extrema +
SURF-style descriptors.

Port of `alicevision_tpu/features/akaze.py`, the redesign of the
reference's native AKAZE implementation (ref:
src/aliceVision/feature/akaze/AKAZE.cpp nonlinear scale space,
descriptorMSURF.hpp MSURF descriptor; options in feature/akaze/AKAZE.hpp):

  * the FED (fast explicit diffusion) inner solver is replaced by plain
    explicit diffusion steps at the stability limit: a Python loop of fused
    elementwise stencils over the whole batch of images;
  * detection and descriptors follow the same fixed-capacity batched
    pattern as SIFT (top-K + validity masks, rotated patches gathered from
    the (B, S, H, W) level stack at each keypoint's level);
  * the descriptor is the 64-d MSURF/SURF layout (4x4 subregions of
    Gauss-weighted (sum dx, sum dy, sum |dx|, sum |dy|)), L2-normalized, or
    the 486-bit M-LDB.

Images are (H, W) or (B, H, W); the features come back with the input's
leading dimensions, on its device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..image.filtering import gaussian_blur
from .sift import SiftFeatures, _gather_rotated_patch, _orientation


class AkazeConfig(NamedTuple):
    max_keypoints: int = 4096
    n_octaves: int = 4
    n_sublevels: int = 4
    threshold: float = 1e-3  # Hessian response threshold
    sigma0: float = 1.6
    diffusivity_percentile: float = 70.0  # contrast factor k
    descriptor: str = "msurf"  # "msurf" (64-d float) | "mldb" (486-bit binary)


def _roll(a, dy, dx):
    return torch.roll(a, (dy, dx), dims=(-2, -1))


def _grad(img):
    gx = 0.5 * (torch.roll(img, -1, -1) - torch.roll(img, 1, -1))
    gy = 0.5 * (torch.roll(img, -1, -2) - torch.roll(img, 1, -2))
    return gx, gy


def _pm_g2(img, k):
    """Perona-Malik g2 conductivity: 1 / (1 + |grad|^2 / k^2)."""
    gx, gy = _grad(img)
    return 1.0 / (1.0 + (gx * gx + gy * gy) / (k * k))


def _diffusion_steps(L, k, t_total, tau=0.23):
    """Explicit nonlinear diffusion of L (B, H, W) from time 0 to t_total;
    k: (B, 1, 1)."""
    n = max(1, int(math.ceil(t_total / tau)))
    step = t_total / n
    for _ in range(n):
        c = _pm_g2(L, k)
        # divergence of c * grad L (standard 4-neighbour discretization)
        cN = 0.5 * (c + torch.roll(c, 1, -2))
        cS = 0.5 * (c + torch.roll(c, -1, -2))
        cW = 0.5 * (c + torch.roll(c, 1, -1))
        cE = 0.5 * (c + torch.roll(c, -1, -1))
        dL = (
            cN * (torch.roll(L, 1, -2) - L)
            + cS * (torch.roll(L, -1, -2) - L)
            + cW * (torch.roll(L, 1, -1) - L)
            + cE * (torch.roll(L, -1, -1) - L)
        )
        L = L + step * dL
    return L


def contrast_factor(img: torch.Tensor, cfg: "AkazeConfig") -> torch.Tensor:
    """The diffusion's contrast factor k of each image (B, H, W) -> (B,).

    Like the reference's kcontrast computation, only *significant*
    gradients enter the percentile, otherwise mostly-flat images give a
    near-zero k that freezes the diffusion everywhere. `torch.nanquantile`
    interpolates linearly, as `jnp.nanpercentile`; it takes one image at a
    time, below its limit of 2^24 elements."""
    smooth = gaussian_blur(img, 1.0)
    gx, gy = _grad(smooth)
    mag = torch.sqrt(gx * gx + gy * gy).flatten(-2)
    sig = torch.where(mag > 0.02 * mag.amax(-1, keepdim=True), mag, torch.full_like(mag, math.nan))
    q = cfg.diffusivity_percentile / 100.0
    k = torch.stack([torch.nanquantile(s, q) for s in sig])
    return torch.where(torch.isfinite(k), k, torch.full_like(k, 1e-2)).clamp(min=1e-4)


def build_nonlinear_scale_space(img: torch.Tensor, cfg: AkazeConfig):
    """Evolution levels of the nonlinear scale space of images (B, H, W).

    Returns (levels [(B, S, H_o, W_o) per octave], sigmas per octave (lists
    of floats), steps, k (B,))."""
    k = contrast_factor(img, cfg)
    kb = k[:, None, None]
    L = gaussian_blur(img, cfg.sigma0)
    t_cur = 0.5 * cfg.sigma0**2
    octaves, sigmas, steps = [], [], []
    step = 1.0
    for o in range(cfg.n_octaves):
        levels = []
        sigs = []
        for s in range(cfg.n_sublevels):
            sigma = cfg.sigma0 * (2.0 ** (o + s / cfg.n_sublevels))
            t = 0.5 * (sigma / step) ** 2  # time in current resolution units
            if t > t_cur:
                L = _diffusion_steps(L, kb, t - t_cur)
                t_cur = t
            levels.append(L)
            sigs.append(sigma / step)  # octave units
        octaves.append(torch.stack(levels, 1))
        sigmas.append(sigs)
        steps.append(step)
        # next octave: downsample, halve time scale
        L = L[:, ::2, ::2]
        t_cur = t_cur / 4.0
        step *= 2.0
    return octaves, sigmas, steps, k


def _hessian_response(L, sigma):
    """Scale-normalized determinant of Hessian of (..., H, W)."""
    Lxx = torch.roll(L, -1, -1) + torch.roll(L, 1, -1) - 2 * L
    Lyy = torch.roll(L, -1, -2) + torch.roll(L, 1, -2) - 2 * L
    Lxy = 0.25 * (
        _roll(L, 1, 1)
        + _roll(L, -1, -1)
        - _roll(L, 1, -1)
        - _roll(L, -1, 1)
    )
    return (sigma**2) ** 2 * (Lxx * Lyy - Lxy * Lxy)


def _msurf_descriptor(stack, cx, cy, sigma, angle, lvl, n_sub=4, samples=5):
    """64-d MSURF-style descriptors (B, K, 64) from rotated resampled grids
    on level `lvl` (B, K) of the (B, S, H, W) stack."""
    G = n_sub * samples  # 20 samples across the 20-sigma window
    spacing = 20.0 * sigma / G
    patch = _gather_rotated_patch(stack, cx, cy, spacing, angle, G, lvl)
    dx = 0.5 * (patch[..., 1:-1, 2:] - patch[..., 1:-1, :-2])
    dy = 0.5 * (patch[..., 2:, 1:-1] - patch[..., :-2, 1:-1])

    g = torch.arange(G, dtype=torch.float32, device=stack.device) - (G - 1) / 2.0
    yy, xx = torch.meshgrid(g, g, indexing="ij")
    w = torch.exp(-(xx * xx + yy * yy) / (2.0 * (0.33 * G) ** 2))
    dx = dx * w
    dy = dy * w

    def pool(a):
        return a.reshape(a.shape[:-2] + (n_sub, samples, n_sub, samples)).sum(dim=(-3, -1))

    feats = torch.stack([pool(dx), pool(dy), pool(dx.abs()), pool(dy.abs())], dim=-1)  # (B, K, 4, 4, 4)
    d = feats.flatten(-3)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-12)


MLDB_BITS = 486  # 3 channels x (C(4,2) + C(9,2) + C(16,2)) pair comparisons


def _mldb_descriptor(stack, cx, cy, sigma, angle, lvl, G=24):
    """486-bit M-LDB (Modified Local Difference Binary) descriptors
    (B, K, 486) (ref: feature/akaze/descriptorMLDB.hpp — AKAZE's binary
    descriptor: per-cell means of (intensity, dx, dy) on 2x2 / 3x3 / 4x4
    grids of the rotated patch, one bit per ordered cell pair per channel).

    Returned as float {0, 1}: for binary vectors the squared-L2 matmul
    identity is the Hamming distance, so the float matchers apply
    unchanged."""
    spacing = 20.0 * sigma / G
    patch = _gather_rotated_patch(stack, cx, cy, spacing, angle, G, lvl)  # (B, K, G+2, G+2)
    inner = patch[..., 1:-1, 1:-1]  # (B, K, G, G)
    dx = 0.5 * (patch[..., 1:-1, 2:] - patch[..., 1:-1, :-2])
    dy = 0.5 * (patch[..., 2:, 1:-1] - patch[..., :-2, 1:-1])
    chans = torch.stack([inner, dx, dy], dim=-3)  # (B, K, 3, G, G)
    lead = chans.shape[:-2]

    bits = []
    for g in (2, 3, 4):
        s = G // g
        cells = chans.reshape(lead + (g, s, g, s)).mean(dim=(-3, -1))  # (B, K, 3, g, g)
        flat = cells.flatten(-2)
        iu, ju = torch.triu_indices(g * g, g * g, offset=1, device=stack.device)
        cmp = flat[..., iu] > flat[..., ju]  # (B, K, 3, n_pairs)
        bits.append(cmp.flatten(-2))
    return torch.cat(bits, dim=-1).to(torch.float32)


def extract(img: torch.Tensor, cfg: AkazeConfig = AkazeConfig()) -> SiftFeatures:
    """AKAZE detection + MSURF/MLDB description of grayscale images (H, W)
    or (B, H, W), fixed-capacity output.

    Returns the same structure as SIFT (desc is (..., N, 64) float for
    MSURF or (..., N, 486) binary-as-float for MLDB). No value is read back
    to the host."""
    single = img.dim() == 2
    x = img[None] if single else img
    octaves, sigmas, steps, _ = build_nonlinear_scale_space(x, cfg)
    budget = max(256, cfg.max_keypoints // max(1, len(octaves)))

    all_out = []
    for gauss, sigs, step in zip(octaves, sigmas, steps):
        B, S, H, W = gauss.shape
        sig_t = torch.tensor(sigs, dtype=torch.float32, device=x.device)
        resp = _hessian_response(gauss, sig_t[:, None, None])  # (B, S, H, W)

        # AKAZE's actual extremum rule: strict max over the 8 spatial
        # neighbours at the same level, plus the same-position responses at
        # the adjacent evolution levels (AKAZE.cpp findScaleSpaceExtrema).
        center = resp[:, 1:-1] if S > 2 else resp
        lo = 1 if S > 2 else 0
        neigh = torch.full_like(center, -math.inf)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                neigh = torch.maximum(neigh, _roll(center, dy, dx))
        if S > 2:
            neigh = torch.maximum(neigh, resp[:, lo - 1 : lo - 1 + center.shape[1]])
            neigh = torch.maximum(neigh, resp[:, lo + 1 : lo + 1 + center.shape[1]])
        cand = (center > neigh) & (center > cfg.threshold)
        yy = torch.arange(H, device=x.device)[:, None]
        xx = torch.arange(W, device=x.device)[None, :]
        b = 10
        cand = cand & ((yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b))

        score = torch.where(cand, center, torch.zeros_like(center)).flatten(1)
        vals, flat = torch.topk(score, budget, dim=1)
        valid = vals > 0
        s_idx = flat // (H * W) + lo
        rem = flat % (H * W)
        y_idx = (rem // W).to(torch.float32)
        x_idx = (rem % W).to(torch.float32)
        sig_of = sig_t[s_idx.clamp(0, S - 1)]

        theta = _orientation(gauss, x_idx, y_idx, sig_of, s_idx)
        if cfg.descriptor == "mldb":
            desc = _mldb_descriptor(gauss, x_idx, y_idx, sig_of, theta, s_idx)
        else:
            desc = _msurf_descriptor(gauss, x_idx, y_idx, sig_of, theta, s_idx)
        all_out.append((torch.stack([x_idx, y_idx], -1) * step, sig_of * step, theta, vals, desc, valid))

    xy, scale, theta, resp, desc, valid = (torch.cat([o[i] for o in all_out], dim=1) for i in range(6))

    N = cfg.max_keypoints
    score = torch.where(valid, resp, torch.full_like(resp, -1.0))
    _, top = torch.topk(score, min(N, score.shape[1]), dim=1)
    pad = N - top.shape[1]

    def take(a):
        idx = top.reshape(top.shape + (1,) * (a.dim() - 2)).expand(top.shape + a.shape[2:])
        t = torch.gather(a, 1, idx)
        if pad > 0:
            t = torch.cat([t, torch.zeros((t.shape[0], pad) + t.shape[2:], dtype=t.dtype, device=t.device)], 1)
        return t[0] if single else t

    return SiftFeatures(
        xy=take(xy),
        scale=take(scale),
        orientation=take(theta),
        response=take(resp),
        desc=take(desc),
        valid=take(valid),
    )
