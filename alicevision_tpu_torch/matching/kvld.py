"""K-VLD match validation: Virtual Line Descriptors.

Port of `alicevision_tpu/matching/kvld.py`, the counterpart of the
reference's KVLD filter (ref: src/aliceVision/matching/kvld/kvld.h —
dimension=10 SIFT-like disks along the virtual line between two matches,
24-bin main directions, gvld-consistency score thresholded at juge=0.35,
matches kept when enough neighbor matches are photometrically consistent
with them).

Every candidate match pair is one row of a batched segment-descriptor
computation: `DIMENSION` disks per segment, each disk an 8x8 resampled
patch reduced to gradient-orientation histograms. The histograms are
one-hot sums, not scatter-adds: a card's atomic adds sum in no fixed order,
and the main direction is an argmax over them. The pair budget is bounded
by taking each match's nearest neighbor matches (host numpy, as the JAX
package picks them).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from ..features.sift import _gather_rotated_patch

DIMENSION = 10  # disks per virtual line (kvld.h:39)
N_ORI = 8  # orientation bins per disk
BIN_NUM = 24  # main-direction bins (kvld.h:41)
JUGE = 0.35  # consistency threshold (kvld.h:32)
MIN_DIST = 10.0  # minimal segment length in px (kvld.h:35)

# segments scored a call: bounds the (P, DIMENSION, 64, BIN_NUM) one-hot
_CHUNK = 2048


def _histogram(bins: torch.Tensor, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Sum of `weights` per bin over the last axis, as a one-hot product."""
    onehot = bins[..., None] == torch.arange(n, device=bins.device)
    return (onehot.to(weights.dtype) * weights[..., None]).sum(-2)


def _vld_segment(img, a, b):
    """VLD of segments a->b (P, 2) in img (H, W): per-disk orientation
    histograms (P, DIMENSION, N_ORI), main angles (P, DIMENSION), weights
    (P, DIMENSION)."""
    d = b - a
    length = torch.linalg.norm(d, dim=-1).clamp(min=1e-6)
    ang = torch.atan2(d[:, 1], d[:, 0])
    radius = length / (DIMENSION * 1.0)  # disks tiling the segment
    G = 8
    t = (torch.arange(DIMENSION, dtype=torch.float32, device=img.device) + 0.5) / DIMENSION
    c = a[:, None, :] + t[None, :, None] * d[:, None, :]  # (P, DIMENSION, 2)
    patch = _gather_rotated_patch(img, c[..., 0], c[..., 1], (2.0 * radius / G)[:, None], ang[:, None], G)
    gx = 0.5 * (patch[..., 1:-1, 2:] - patch[..., 1:-1, :-2])
    gy = 0.5 * (patch[..., 2:, 1:-1] - patch[..., :-2, 1:-1])
    mag = torch.sqrt(gx * gx + gy * gy).flatten(-2)
    th = torch.atan2(gy, gx).flatten(-2)  # relative to segment (patch is rotated)
    binf = (th + math.pi) / (2 * math.pi) * N_ORI
    b0 = torch.floor(binf).to(torch.int64) % N_ORI
    hist = _histogram(b0, mag, N_ORI)
    w = mag.sum(-1)
    # main direction on a finer circular grid (BIN_NUM)
    bm = torch.floor((th + math.pi) / (2 * math.pi) * BIN_NUM).to(torch.int64) % BIN_NUM
    main = torch.argmax(_histogram(bm, mag, BIN_NUM), dim=-1)  # first maximum, as jnp.argmax
    hist = hist / hist.sum(-1, keepdim=True).clamp(min=1e-9)
    return hist, main, w / w.sum(-1, keepdim=True).clamp(min=1e-9)


def _pair_score(img1, img2, a1, b1, a2, b2):
    """gvld-style consistency of each virtual line (P,) in both images:
    weighted histogram distance + circular main-angle difference
    (kvld.h:110-123)."""
    h1, m1, w1 = _vld_segment(img1, a1, b1)
    h2, m2, w2 = _vld_segment(img2, a2, b2)
    w = 0.5 * (w1 + w2)
    d_desc = (w * (h1 - h2).abs().sum(-1)).sum(-1) * 0.5
    dm = (m1 - m2).abs()
    dm = torch.minimum(dm, BIN_NUM - dm).to(torch.float32)
    d_ang = (w * dm).sum(-1) * (0.64 / BIN_NUM) * 4.0
    return d_desc * 0.5 + d_ang * 0.5


def kvld_filter(
    img1,
    img2,
    xy1: np.ndarray,  # (M, 2) matched keypoint positions in image 1
    xy2: np.ndarray,  # (M, 2) in image 2
    n_neighbors: int = 10,
    min_support: int = 2,
    juge: float = JUGE,
    min_dist: float = MIN_DIST,
    max_length_ratio: float = 2.0,
    device="cuda",
) -> np.ndarray:
    """Keep matches supported by >= min_support consistent virtual lines.

    Returns (M,) bool. Pair candidates are each match's n_neighbors nearest
    matches; a pair is geometrically admissible when both segments are
    longer than min_dist and their length ratio is bounded, and
    photometrically consistent when the gvld score is below juge.
    """
    dev = resolve_device(device)
    xy1 = np.asarray(xy1, np.float32)
    xy2 = np.asarray(xy2, np.float32)
    M = len(xy1)
    if M < min_support + 1:
        return np.ones(M, bool)
    k = min(n_neighbors, M - 1)

    d = np.linalg.norm(xy1[:, None] - xy1[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    nbr = np.argpartition(d, k - 1, axis=1)[:, :k]  # (M, k)
    ii = np.repeat(np.arange(M), k)
    jj = nbr.reshape(-1)

    len1 = np.linalg.norm(xy1[ii] - xy1[jj], axis=-1)
    len2 = np.linalg.norm(xy2[ii] - xy2[jj], axis=-1)
    ratio = np.maximum(len1, len2) / np.maximum(np.minimum(len1, len2), 1e-6)
    admissible = (len1 > min_dist) & (len2 > min_dist) & (ratio < max_length_ratio)

    sel = np.nonzero(admissible)[0]
    if len(sel) == 0:
        return np.ones(M, bool)
    im1 = torch.tensor(np.asarray(img1, np.float32), device=dev)
    im2 = torch.tensor(np.asarray(img2, np.float32), device=dev)
    p1 = torch.as_tensor(xy1, device=dev)
    p2 = torch.as_tensor(xy2, device=dev)
    si = torch.as_tensor(ii[sel], device=dev)
    sj = torch.as_tensor(jj[sel], device=dev)
    scores = torch.cat([
        _pair_score(im1, im2, p1[a], p1[b], p2[a], p2[b])
        for a, b in zip(si.split(_CHUNK), sj.split(_CHUNK))
    ]).cpu().numpy()

    consistent = scores < juge
    support = np.zeros(M, np.int64)
    np.add.at(support, ii[sel][consistent], 1)
    np.add.at(support, jj[sel][consistent], 1)
    return support >= min_support
