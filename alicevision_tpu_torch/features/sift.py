"""SIFT / DSP-SIFT feature extraction on tensors.

Port of `alicevision_tpu/features/sift.py` (ref:
src/aliceVision/feature/sift/SIFT.hpp:35-60 params,
ImageDescriber_DSPSIFT_vlfeat.cpp:71-148 detection + :304-311 domain-size
pooling). The same fixed-capacity design:

  * Gaussian scale space + DoG per octave (banded-matrix blurs);
  * extrema from 26-neighbour comparisons of rolled arrays;
  * at most one keypoint per 4x4 cell per scale, top-K by |DoG| per octave,
    one 3x3 Hessian solve per candidate (closed form);
  * orientation from a 36-bin gradient histogram over a gathered patch;
  * descriptor: 4x4x8 trilinear binning over a rotated resampled grid,
    normalized / clipped (0.2) / renormalized, rootSIFT, uint8 quantization
    (x512) apart;
  * DSP-SIFT: descriptors averaged over `dsp_n_scales` domain sizes.

Where the reference vmaps a function over keypoints (and `stages.py` over
images), every function here carries the batch of images and the keypoint
axis as leading tensor dimensions: the taps of all keypoints of all images
are one flat `gather` into the (B, L*H*W) Gaussian stacks. `extract` takes
(H, W) or (B, H, W). Ties among invalid slots come out of `torch.topk` in
another order than out of `lax.top_k`; valid keypoints, sorted by response,
do not depend on it.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..image.filtering import downsample2, gaussian_blur, upsample2
from ..numeric import f32_matmuls


class SiftConfig(NamedTuple):
    max_keypoints: int = 10000
    n_octaves: int = 4
    n_scales: int = 3  # scales per octave (S); S+3 gaussian, S+2 DoG levels
    first_octave: int = 0  # -1 = upsample input 2x first
    peak_threshold: float = 0.005  # on DoG, relative contrast
    edge_threshold: float = 10.0
    sigma0: float = 1.6  # base blur of octave 0
    init_sigma: float = 0.5  # assumed blur of the input image
    root_sift: bool = True
    # DSP pooling (ImageDescriber_DSPSIFT_vlfeat.hpp:29-31)
    dsp: bool = False
    dsp_n_scales: int = 10
    dsp_min: float = 1.0 / 6.0
    dsp_max: float = 3.0
    # descriptor geometry
    n_spatial_bins: int = 4
    n_ori_bins: int = 8
    magnif: float = 3.0  # bin size in units of keypoint scale
    patch_grid: int = 16  # resampled grid (G x G) covering the window


class SiftFeatures(NamedTuple):
    xy: torch.Tensor  # (..., N, 2) pixel coords in the input image
    scale: torch.Tensor  # (..., N) blur scale (sigma, input-image units)
    orientation: torch.Tensor  # (..., N) radians
    response: torch.Tensor  # (..., N) |DoG| response
    desc: torch.Tensor  # (..., N, 128) float32 (normalized) — quantize separately
    valid: torch.Tensor  # (..., N) bool


# ---------------------------------------------------------------------------
# Scale space
# ---------------------------------------------------------------------------


def build_scale_space(img: torch.Tensor, cfg: SiftConfig):
    """Gaussian pyramid of (..., H, W) images: list over octaves of
    (..., S+3, H_o, W_o) stacks, plus the per-octave sampling step relative
    to the input image."""
    S = cfg.n_scales
    k = 2.0 ** (1.0 / S)
    base = img
    step0 = 1.0
    if cfg.first_octave == -1:
        base = upsample2(img)
        step0 = 0.5

    # Bring the base image to sigma0 blur.
    cur_sigma = cfg.init_sigma / step0
    if cfg.sigma0 > cur_sigma:
        base = gaussian_blur(base, math.sqrt(cfg.sigma0**2 - cur_sigma**2))

    octaves = []
    steps = []
    for o in range(cfg.n_octaves):
        levels = [base]
        sigma_prev = cfg.sigma0
        for s in range(1, S + 3):
            sigma_target = cfg.sigma0 * (k**s)
            dsigma = math.sqrt(sigma_target**2 - sigma_prev**2)
            levels.append(gaussian_blur(levels[-1], dsigma))
            sigma_prev = sigma_target
        octaves.append(torch.stack(levels, dim=-3))  # (..., S+3, H, W)
        steps.append(step0 * (2.0**o))
        # Next octave starts from the level with blur 2*sigma0 (index S).
        base = downsample2(levels[S])
    return octaves, steps


# ---------------------------------------------------------------------------
# Extrema detection per octave
# ---------------------------------------------------------------------------


def _shift2(a, dy, dx):
    return torch.roll(a, shifts=(dy, dx), dims=(-2, -1))


def _detect_octave(gauss: torch.Tensor, step: float, cfg: SiftConfig, k_budget: int):
    """Detect + refine extrema in one octave of a batch of images.

    gauss: (B, S+3, H, W). Returns a fixed-size candidate set per image:
      xy (B, K, 2) input-image coords, scale (B, K), response (B, K),
      level (B, K), valid (B, K), and (x_o, y_o, sigma_oct) in octave units
      for the patch sampling.
    """
    S = cfg.n_scales
    dev = gauss.device
    dog = gauss[:, 1:] - gauss[:, :-1]  # (B, S+2, H, W)
    Bn, _, H, W = dog.shape

    # 26-neighbour max/min via shifted arrays on the S interior scales.
    center = dog[:, 1:-1]  # (B, S, H, W)
    neigh_max = torch.full_like(center, -math.inf)
    neigh_min = torch.full_like(center, math.inf)
    for ds in (-1, 0, 1):
        lvl = dog[:, 1 + ds : 1 + ds + S]
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                sh = _shift2(lvl, dy, dx)
                neigh_max = torch.maximum(neigh_max, sh)
                neigh_min = torch.minimum(neigh_min, sh)

    thr = cfg.peak_threshold
    is_max = (center > neigh_max) & (center > thr)
    is_min = (center < neigh_min) & (center < -thr)
    cand = is_max | is_min

    # Edge rejection: ratio of principal curvatures of the 2x2 spatial Hessian.
    dxx = _shift2(center, 0, 1) + _shift2(center, 0, -1) - 2 * center
    dyy = _shift2(center, 1, 0) + _shift2(center, -1, 0) - 2 * center
    dxy = 0.25 * (
        _shift2(center, 1, 1)
        + _shift2(center, -1, -1)
        - _shift2(center, 1, -1)
        - _shift2(center, -1, 1)
    )
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = cfg.edge_threshold
    edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)
    cand = cand & edge_ok

    # Exclude a border margin.
    yy = torch.arange(H, device=dev)[None, None, :, None]
    xx = torch.arange(W, device=dev)[None, None, None, :]
    b = 5
    cand = cand & (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)

    resp = torch.abs(center)
    score = torch.where(cand, resp, torch.zeros_like(resp))
    # At most one keypoint per 4x4 cell per scale (the reference's grid
    # filtering of maxTotalKeypoints, SIFT.hpp:38-50): the cells' maxima
    # go through top-k, then each winner's position inside its cell.
    Bc = 4
    Hp, Wp = (H // Bc) * Bc, (W // Bc) * Bc
    Hb, Wb = Hp // Bc, Wp // Bc
    blk = score[:, :, :Hp, :Wp].reshape(Bn, S, Hb, Bc, Wb, Bc)
    blk_max = blk.amax(dim=(3, 5))  # (B, S, Hb, Wb)
    k_eff = min(k_budget, S * Hb * Wb)
    vals, bidx = torch.topk(blk_max.reshape(Bn, -1), k_eff, dim=-1)
    if k_eff < k_budget:  # tiny octaves: pad back to the fixed budget
        vals = torch.nn.functional.pad(vals, (0, k_budget - k_eff))
        bidx = torch.nn.functional.pad(bidx, (0, k_budget - k_eff))
    valid = vals > 0.0
    s_idx = bidx // (Hb * Wb)
    rem = bidx % (Hb * Wb)
    by = rem // Wb
    bx = rem % Wb
    iy = torch.arange(Bc, device=dev)[:, None]
    ix = torch.arange(Bc, device=dev)[None, :]
    lin = (
        s_idx[..., None, None] * (H * W)
        + (by[..., None, None] * Bc + iy) * W
        + (bx[..., None, None] * Bc + ix)
    )  # (B, K, 4, 4)
    cell = torch.gather(score.reshape(Bn, -1), 1, lin.reshape(Bn, -1)).reshape(Bn, k_budget, Bc * Bc)
    off = torch.argmax(cell, dim=-1)  # first maximum, as jnp.argmax
    y_idx = by * Bc + off // Bc
    x_idx = bx * Bc + off % Bc

    # Subpixel refinement: 3D quadratic fit about each candidate, all 27
    # taps of all candidates in one gather. Slots that are not candidates
    # may reach past the volume; their indices are clamped (the reference's
    # take fills them with NaN), and they stay invalid either way.
    offsets27 = [(ds, dy, dx) for ds in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    o = torch.arange(-1, 2, device=dev)  # built on the device: no host copy
    off_lin = (o[:, None, None] * (H * W) + o[None, :, None] * W + o[None, None, :]).reshape(27)
    base = ((s_idx + 1) * H + y_idx) * W + x_idx  # (B, K)
    lin27 = (base[..., None] + off_lin).clamp(0, (S + 2) * H * W - 1)  # (B, K, 27)
    vals27 = torch.gather(dog.reshape(Bn, -1), 1, lin27.reshape(Bn, -1)).reshape(lin27.shape)
    v27 = {o: vals27[..., i] for i, o in enumerate(offsets27)}

    def val(ds, dy, dx):
        return v27[(ds, dy, dx)]

    g = torch.stack(
        [
            0.5 * (val(0, 0, 1) - val(0, 0, -1)),
            0.5 * (val(0, 1, 0) - val(0, -1, 0)),
            0.5 * (val(1, 0, 0) - val(-1, 0, 0)),
        ],
        dim=-1,
    )  # (B, K, 3)
    hxx = val(0, 0, 1) + val(0, 0, -1) - 2 * val(0, 0, 0)
    hyy = val(0, 1, 0) + val(0, -1, 0) - 2 * val(0, 0, 0)
    hss = val(1, 0, 0) + val(-1, 0, 0) - 2 * val(0, 0, 0)
    hxy = 0.25 * (val(0, 1, 1) + val(0, -1, -1) - val(0, 1, -1) - val(0, -1, 1))
    hxs = 0.25 * (val(1, 0, 1) + val(-1, 0, -1) - val(1, 0, -1) - val(-1, 0, 1))
    hys = 0.25 * (val(1, 1, 0) + val(-1, -1, 0) - val(1, -1, 0) - val(-1, 1, 0))
    # closed-form symmetric 3x3 solve (adjugate / Cramer)
    a_, b_, c_ = hxx + 1e-8, hxy, hxs
    d_, e_, f_ = hyy + 1e-8, hys, hss + 1e-8
    A11 = d_ * f_ - e_ * e_
    A12 = c_ * e_ - b_ * f_
    A13 = b_ * e_ - c_ * d_
    A22 = a_ * f_ - c_ * c_
    A23 = b_ * c_ - a_ * e_
    A33 = a_ * d_ - b_ * b_
    det = a_ * A11 + b_ * A12 + c_ * A13
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    gx_, gy_, gs_ = g[..., 0], g[..., 1], g[..., 2]
    offs = -torch.stack(
        [
            (A11 * gx_ + A12 * gy_ + A13 * gs_) / det,
            (A12 * gx_ + A22 * gy_ + A23 * gs_) / det,
            (A13 * gx_ + A23 * gy_ + A33 * gs_) / det,
        ],
        dim=-1,
    )
    offs = torch.clamp(offs, -0.6, 0.6)
    d_hat = val(0, 0, 0) + 0.5 * torch.sum(g * offs, dim=-1)
    valid = valid & (torch.abs(d_hat) > thr)

    x_o = x_idx.to(torch.float32) + offs[..., 0]
    y_o = y_idx.to(torch.float32) + offs[..., 1]
    s_o = s_idx.to(torch.float32) + 1.0 + offs[..., 2]  # gaussian level coords

    k = 2.0 ** (1.0 / S)
    sigma_oct = cfg.sigma0 * (k**s_o)  # octave units
    xy = torch.stack([x_o, y_o], dim=-1) * step  # input-image coords
    sigma = sigma_oct * step
    level = torch.clamp(torch.round(s_o).to(torch.int64), 0, S + 2)
    return xy, sigma, torch.abs(d_hat), level, valid, (x_o, y_o, sigma_oct)


# ---------------------------------------------------------------------------
# Orientation + descriptor from gathered patches
# ---------------------------------------------------------------------------


def _stack_taps(stack: torch.Tensor, lvl, ys, xs) -> torch.Tensor:
    """Values of the (B, L, H, W) stack at integer (level, y, x) taps of
    shape (B, ...), 0 outside the image: one flat gather per call."""
    Bn, _, H, W = stack.shape
    inside = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    lin = (lvl * H + ys.clamp(0, H - 1)) * W + xs.clamp(0, W - 1)
    v = torch.gather(stack.reshape(Bn, -1), 1, lin.reshape(Bn, -1)).reshape(lin.shape)
    return torch.where(inside, v, torch.zeros_like(v))


def _grid(G: int, device):
    g = torch.arange(G + 2, dtype=torch.float32, device=device) - (G + 1) / 2.0
    return torch.meshgrid(g, g, indexing="ij")  # gy, gx


def _gather_rotated_patch(stack, cx, cy, spacing, angle, G, lvl):
    """Resample a (G+2)x(G+2) grid centered at (cx, cy), rotated by angle,
    with the given spacing (octave pixels per grid step), bilinearly, on
    level `lvl` of the (B, L, H, W) Gaussian stack. cx, cy, spacing, angle,
    lvl: (B, K). Returns (B, K, G+2, G+2)."""
    gy, gx = _grid(G, stack.device)
    ca, sa = torch.cos(angle)[..., None, None], torch.sin(angle)[..., None, None]
    sx = spacing[..., None, None] * (ca * gx - sa * gy) + cx[..., None, None]
    sy = spacing[..., None, None] * (sa * gx + ca * gy) + cy[..., None, None]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    lvl = lvl[..., None, None]
    return (
        _stack_taps(stack, lvl, y0i, x0i) * (1 - fx) * (1 - fy)
        + _stack_taps(stack, lvl, y0i, x0i + 1) * fx * (1 - fy)
        + _stack_taps(stack, lvl, y0i + 1, x0i) * (1 - fx) * fy
        + _stack_taps(stack, lvl, y0i + 1, x0i + 1) * fx * fy
    )


def _orientation(stack, cx, cy, sigma_oct, lvl):
    """Dominant gradient orientation (VLFeat-style 36-bin histogram) of
    each (B, K) keypoint."""
    G = 16
    win = 3.0 * 1.5 * sigma_oct  # window radius
    spacing = 2.0 * win / G
    patch = _gather_rotated_patch(stack, cx, cy, spacing, torch.zeros_like(cx), G, lvl)
    gx = 0.5 * (patch[..., 1:-1, 2:] - patch[..., 1:-1, :-2])
    gy = 0.5 * (patch[..., 2:, 1:-1] - patch[..., :-2, 1:-1])
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)  # [-pi, pi)

    g = torch.arange(G, dtype=torch.float32, device=stack.device) - (G - 1) / 2.0
    yy, xx = torch.meshgrid(g, g, indexing="ij")
    r2 = (xx * xx + yy * yy) * spacing[..., None, None] ** 2
    w = torch.exp(-r2 / (2.0 * (1.5 * sigma_oct[..., None, None]) ** 2)) * mag

    nb = 36
    bin_f = (ang + math.pi) / (2 * math.pi) * nb
    b0 = torch.floor(bin_f).to(torch.int64) % nb
    lead = w.shape[:-2]
    hist = torch.zeros(lead + (nb,), dtype=w.dtype, device=w.device)
    hist.scatter_add_(-1, b0.reshape(lead + (-1,)), w.reshape(lead + (-1,)))
    # Circular smoothing (6 passes of [1,1,1]/3 like VLFeat).
    for _ in range(6):
        hist = (torch.roll(hist, 1, dims=-1) + hist + torch.roll(hist, -1, dims=-1)) / 3.0
    bmax = torch.argmax(hist, dim=-1, keepdim=True)  # first maximum, as jnp.argmax
    # Parabolic interpolation of the peak.
    hl = torch.gather(hist, -1, (bmax - 1) % nb)[..., 0]
    hc = torch.gather(hist, -1, bmax)[..., 0]
    hr = torch.gather(hist, -1, (bmax + 1) % nb)[..., 0]
    denom = hl - 2 * hc + hr
    off = torch.where(torch.abs(denom) > 1e-12, 0.5 * (hl - hr) / denom, torch.zeros_like(denom))
    theta = (bmax[..., 0].to(torch.float32) + off + 0.5) / nb * 2 * math.pi - math.pi
    return theta


def _gather_rotated_patches_multi(stack, cx, cy, spacings, angle, G, lvls):
    """(B, K, S, G+2, G+2) rotated patches for S (spacing, level) pairs per
    keypoint in one flat gather (DSP pooling samples all domain sizes at
    once). spacings, lvls: (B, K, S); cx, cy, angle: (B, K).

    One tap per grid point, at the nearest pixel, as the reference samples
    (its `nearest=True`; the bilinear branch has no caller and is not
    carried): the ±0.5 px placement jitter is uncorrelated across the
    pooled domain sizes and washes out in the DSP mean."""
    gy, gx = _grid(G, stack.device)
    ca, sa = torch.cos(angle)[..., None, None, None], torch.sin(angle)[..., None, None, None]
    sp = spacings[..., None, None]
    sx = sp * (ca * gx - sa * gy) + cx[..., None, None, None]
    sy = sp * (sa * gx + ca * gy) + cy[..., None, None, None]
    xs = torch.round(sx).to(torch.int64)
    ys = torch.round(sy).to(torch.int64)
    return _stack_taps(stack, lvls[..., None, None], ys, xs)


@functools.lru_cache(maxsize=8)
def _spatial_bin_matrix_np(NBP: int, G: int) -> np.ndarray:
    """Static (NBP^2, G^2) bilinear spatial-bin weight matrix: entry
    [(p*NBP+q), cell] is the weight of grid cell `cell` in spatial bin
    (p, q) under the descriptor's trilinear interpolation (host numpy, a
    copy of the reference's)."""
    g = (np.arange(G, dtype=np.float64) + 0.5) / G
    yy, xx = np.meshgrid(g, g, indexing="ij")
    bx = (xx * NBP - 0.5).reshape(-1)
    by = (yy * NBP - 0.5).reshape(-1)
    S = np.zeros((NBP, NBP, G * G), np.float32)
    y0 = np.floor(by)
    x0 = np.floor(bx)
    fy = by - y0
    fx = bx - x0
    cells = np.arange(G * G)
    for iy, wy in ((y0.astype(int), 1 - fy), (y0.astype(int) + 1, fy)):
        oky = (iy >= 0) & (iy < NBP)
        for ix, wx in ((x0.astype(int), 1 - fx), (x0.astype(int) + 1, fx)):
            okx = (ix >= 0) & (ix < NBP)
            ok = oky & okx
            np.add.at(
                S,
                (iy.clip(0, NBP - 1), ix.clip(0, NBP - 1), cells),
                np.where(ok, wy * wx, 0.0),
            )
    return S.reshape(NBP * NBP, G * G)


@functools.lru_cache(maxsize=8)
def _spatial_bin_matrix(NBP: int, G: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_spatial_bin_matrix_np(NBP, G)).to(device)


def _descriptor_from_patch(patch, cfg: SiftConfig):
    """Unnormalized 128-dim descriptors from sampled (..., G+2, G+2)
    patches (trilinear binning, Gaussian weight) -> (..., 128)."""
    NBP = cfg.n_spatial_bins
    NBO = cfg.n_ori_bins
    G = cfg.patch_grid
    gx = 0.5 * (patch[..., 1:-1, 2:] - patch[..., 1:-1, :-2])
    gy = 0.5 * (patch[..., 2:, 1:-1] - patch[..., :-2, 1:-1])
    mag = torch.sqrt(gx * gx + gy * gy)
    # The patch is sampled along axes rotated by `angle`, so finite
    # differences are already expressed in the keypoint frame.
    ang = torch.atan2(gy, gx)

    g = (torch.arange(G, dtype=torch.float32, device=patch.device) + 0.5) / G  # (0, 1)
    yy, xx = torch.meshgrid(g, g, indexing="ij")
    # Gaussian window over the whole descriptor support.
    r2 = (xx - 0.5) ** 2 + (yy - 0.5) ** 2
    wg = torch.exp(-r2 / (2.0 * 0.25**2)) * mag

    # Trilinear binning as one (NBP^2, G^2) @ (G^2, NBO) product per patch:
    # the spatial bin weights depend only on the grid, the orientation
    # one-hot on the data.
    bo = (ang % (2 * math.pi)) / (2 * math.pi) * NBO
    o0 = torch.floor(bo)
    fo = bo - o0
    i0 = o0.to(torch.int64) % NBO
    i1 = (i0 + 1) % NBO
    obins = torch.arange(NBO, device=patch.device)
    lead = patch.shape[:-2]
    i0 = i0.reshape(lead + (-1, 1))
    i1 = i1.reshape(lead + (-1, 1))
    fo = fo.reshape(lead + (-1, 1))
    V = wg.reshape(lead + (-1, 1)) * ((i0 == obins) * (1 - fo) + (i1 == obins) * fo)  # (..., G^2, NBO)
    S = _spatial_bin_matrix(NBP, G, patch.device)  # (NBP^2, G^2) static
    return torch.matmul(S, V).reshape(lead + (NBP * NBP * NBO,))


def _descriptor_raw(stack, cx, cy, sigma_oct, angle, cfg: SiftConfig, lvl):
    """Unnormalized 128-dim descriptors at one domain size."""
    G = cfg.patch_grid
    win = cfg.magnif * sigma_oct * cfg.n_spatial_bins / 2.0
    spacing = 2.0 * win / G
    patch = _gather_rotated_patch(stack, cx, cy, spacing, angle, G, lvl)
    return _descriptor_from_patch(patch, cfg)


def _normalize_desc(d, cfg: SiftConfig):
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-12)
    d = torch.clamp(d, max=0.2)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-12)
    if cfg.root_sift:
        d = torch.sqrt(d / torch.sum(d, dim=-1, keepdim=True).clamp(min=1e-12))
    return d


# ---------------------------------------------------------------------------
# Full extraction
# ---------------------------------------------------------------------------


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """float32 `jnp.linspace`: start * (1 - t) + stop * t with t = i / (num - 1),
    the last value `stop` itself."""
    t = torch.arange(num - 1, dtype=torch.float32, device=device) / float(num - 1)
    lo = torch.tensor(start, dtype=torch.float32, device=device)
    hi = torch.tensor(stop, dtype=torch.float32, device=device)
    return torch.cat([lo * (1 - t) + hi * t, hi[None]])


@f32_matmuls
def extract(img: torch.Tensor, cfg: SiftConfig = SiftConfig()) -> SiftFeatures:
    """Extract SIFT features from grayscale images (H, W) or (B, H, W) in
    [0, 1], on the images' device.

    Returns fixed-capacity tensors of cfg.max_keypoints per image (leading
    dimensions as the input's) with a validity mask. No value is read back
    to the host.
    """
    single = img.dim() == 2
    x = img[None] if single else img
    octaves, steps = build_scale_space(x, cfg)
    per_oct_budget = max(256, cfg.max_keypoints // max(1, len(octaves)))

    all_xy, all_sigma, all_resp, all_valid = [], [], [], []
    all_theta, all_desc = [], []

    for gauss, step in zip(octaves, steps):
        xy, sigma, resp, level, valid, (x_o, y_o, sig_o) = _detect_octave(
            gauss, step, cfg, per_oct_budget
        )
        # The level is a gather coordinate into the (B, L, H, W) stack, so
        # each tap reads one pixel, not a whole image per keypoint.
        theta = _orientation(gauss, x_o, y_o, sig_o, level)
        if cfg.dsp:
            # Each pooled domain is sampled from the Gaussian level whose
            # smoothing matches sigma*s, clamped to the octave
            # (ImageDescriber_DSPSIFT_vlfeat.cpp:304-311); all domain sizes
            # in one gather.
            scales = _linspace(cfg.dsp_min, cfg.dsp_max, cfg.dsp_n_scales, x.device)
            n_lvls = gauss.shape[1]
            dl = torch.round(torch.log2(scales) * cfg.n_scales).to(torch.int64)
            lis = torch.clamp(level[..., None] + dl, 0, n_lvls - 1)
            spacings = (cfg.magnif * sig_o[..., None] * scales * cfg.n_spatial_bins) / cfg.patch_grid
            patches = _gather_rotated_patches_multi(
                gauss, x_o, y_o, spacings, theta, cfg.patch_grid, lis
            )
            descs = _descriptor_from_patch(patches, cfg)  # (B, K, S, 128)
            # L2-normalize per scale before pooling: the raw finite-
            # difference magnitudes grow with the sampling spacing.
            descs = descs / torch.linalg.norm(descs, dim=-1, keepdim=True).clamp(min=1e-12)
            d = torch.mean(descs, dim=-2)
        else:
            d = _descriptor_raw(gauss, x_o, y_o, sig_o, theta, cfg, level)

        all_xy.append(xy)
        all_sigma.append(sigma)
        all_resp.append(resp)
        all_valid.append(valid)
        all_theta.append(theta)
        all_desc.append(_normalize_desc(d, cfg))

    xy = torch.cat(all_xy, dim=1)
    sigma = torch.cat(all_sigma, dim=1)
    resp = torch.cat(all_resp, dim=1)
    valid = torch.cat(all_valid, dim=1)
    theta = torch.cat(all_theta, dim=1)
    desc = torch.cat(all_desc, dim=1)

    # Global top-K by response among valid candidates.
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
        scale=take(sigma),
        orientation=take(theta),
        response=take(resp),
        desc=take(desc),
        valid=take(valid),
    )


def quantize_desc(desc: torch.Tensor) -> torch.Tensor:
    """Float descriptor -> uint8 (x512, clipped), the reference's convention."""
    return torch.clamp(desc * 512.0, 0, 255).to(torch.uint8)
