"""Photometric match verification (the KVLD-style filter).

Port of `alicevision_tpu/matching/photometric_filter.py`, the counterpart
of the reference's KVLD photometric-geometric match filter
(ref: src/aliceVision/matching/kvld/ — virtual line descriptors validating
matches photometrically). Each tentative match is verified by ZNCC between
scale/orientation-normalized patches around the two keypoints: one batched
gather and reduction over the matches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..features.sift import _gather_rotated_patch


def patch_zncc_scores(
    img1: torch.Tensor,
    img2: torch.Tensor,
    xy1: torch.Tensor,  # (M, 2) matched keypoints in image 1
    xy2: torch.Tensor,  # (M, 2)
    scale1: torch.Tensor,  # (M,)
    scale2: torch.Tensor,
    ori1: torch.Tensor,  # (M,) radians
    ori2: torch.Tensor,
    patch: int = 12,
    mag: float = 3.0,
) -> torch.Tensor:
    """ZNCC between normalized patches of each match -> (M,) in [-1, 1]."""
    p1 = _gather_rotated_patch(img1, xy1[:, 0], xy1[:, 1], mag * scale1 / patch * 2, ori1, patch)
    p2 = _gather_rotated_patch(img2, xy2[:, 0], xy2[:, 1], mag * scale2 / patch * 2, ori2, patch)
    a = p1 - p1.mean(dim=(-2, -1), keepdim=True)
    b = p2 - p2.mean(dim=(-2, -1), keepdim=True)
    den = torch.sqrt((a * a).sum(dim=(-2, -1)) * (b * b).sum(dim=(-2, -1))).clamp(min=1e-9)
    return (a * b).sum(dim=(-2, -1)) / den


def photometric_filter(
    img1,
    img2,
    feats1: dict,
    feats2: dict,
    pairs,  # (M, 2) tentative match index pairs
    min_zncc: float = 0.3,
    device="cuda",
):
    """Keep matches whose normalized patches correlate (KVLD-style gate).

    Returns the filtered (M', 2) pairs and the (M,) scores (host numpy)."""
    if len(pairs) == 0:
        return pairs, np.zeros(0)
    dev = resolve_device(device)
    i1 = pairs[:, 0]
    i2 = pairs[:, 1]

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    scores = patch_zncc_scores(
        t(img1),
        t(img2),
        t(feats1["xy"][i1]),
        t(feats2["xy"][i2]),
        t(feats1["scale"][i1]),
        t(feats2["scale"][i2]),
        t(feats1["orientation"][i1]),
        t(feats2["orientation"][i2]),
    )
    scores = scores.cpu().numpy()
    return pairs[scores >= min_zncc], scores
