"""Multi-band Laplacian blending.

Port of `_build_laplacian` and `laplacian_blend` of
`alicevision_tpu/panorama/compositing.py` (ref:
src/aliceVision/panorama/laplacianPyramid.cpp + laplacianCompositer.hpp),
on the port's `gaussian_blur`, `downsample2` and `upsample2`. Texturing's
multi-band fusion blends its per-view atlas layers with it. The distance
seams and the panorama compositor stay in ROADMAP item 13.
"""

from __future__ import annotations

import torch

from ..image.filtering import downsample2, gaussian_blur, upsample2


def _build_laplacian(img: torch.Tensor, levels: int) -> list:
    pyr = []
    cur = img
    for _ in range(levels - 1):
        low = gaussian_blur(cur, 1.0)
        down = downsample2(low)
        up = upsample2(down)[..., : cur.shape[-2], : cur.shape[-1]]
        pyr.append(cur - up)
        cur = down
    pyr.append(cur)
    return pyr


def laplacian_blend(images: torch.Tensor, weights: torch.Tensor, levels: int = 5) -> torch.Tensor:
    """Classic multi-band blending of (V, H, W) single-channel images with
    (V, H, W) normalized weights: a per-level weighted sum of the Laplacians
    with progressively blurred weights (laplacianCompositer.hpp). The views
    go through each level together, as one (V, h, w) batch."""
    lap = _build_laplacian(images, levels)
    wpyr = [weights]
    for _ in range(levels - 1):
        wpyr.append(downsample2(gaussian_blur(wpyr[-1], 1.0)))
    blended = [(lap[l] * wpyr[l]).sum(0) / wpyr[l].sum(0).clamp_min(1e-6) for l in range(levels)]
    out = blended[-1]
    for l in range(levels - 2, -1, -1):
        out = upsample2(out)[..., : blended[l].shape[-2], : blended[l].shape[-1]]
        out = out + blended[l]
    return out
