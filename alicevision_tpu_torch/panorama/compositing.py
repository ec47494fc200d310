"""Panorama compositing: distance seams + multi-band Laplacian blending.

Port of `alicevision_tpu/panorama/compositing.py` (ref:
src/aliceVision/panorama/seams.cpp + distance.cpp — distance feathering,
laplacianPyramid.cpp + laplacianCompositer.hpp — multi-band blending,
graphcut.hpp — graph-cut seams, which `graphcut_seams.py` ports). Every
function takes (V, H, W) stacks on one device and runs there; the views go
through each blur and pyramid level together, as one batch.

The blurs are the padded convolution (`gaussian_blur_conv`, the JAX
package's formulation), not the banded matrix products of
`image/filtering.py::gaussian_blur`: a band matrix costs O(W^2) a row, and
at a panorama width of 8192 it is a 268 MB matrix a blur (PERF.md §6 has
both forms' times on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..image.filtering import downsample2, gaussian_blur_conv, upsample2

gaussian_blur = gaussian_blur_conv


def distance_weights(masks: torch.Tensor, sharpness: float = 0.05) -> torch.Tensor:
    """Per-view blending weights from distance-to-border of each valid mask.

    masks: (V, H, W) bool. Returns (V, H, W) weights summing to 1 where any
    view covers the pixel. Chamfer-style distance via iterated blurs keeps
    everything on the device (an exact EDT is host-bound and unnecessary).
    """
    m = masks.to(torch.float32)
    d = m
    for _ in range(4):
        d = gaussian_blur(d, 2.0) * m
    d = d + 1e-6 * m
    return d / torch.sum(d, dim=0, keepdim=True).clamp(min=1e-6)


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
    with progressively blurred weights (laplacianCompositer.hpp)."""
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


def _covered(pano: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.any(masks, dim=0), pano, torch.zeros_like(pano))


def composite_panorama(warped: torch.Tensor, masks: torch.Tensor, levels: int = 5) -> torch.Tensor:
    """Seam weights + multi-band blend of (V, H, W) warped views with their
    (V, H, W) validity -> final panorama (H, W)."""
    return _covered(laplacian_blend(warped, distance_weights(masks), levels=levels), masks)


def seam_labels(masks: torch.Tensor, sharpness: float = 0.05) -> torch.Tensor:
    """Hard seam assignment: per-pixel winning view by distance weight
    (ref: panorama/seams.cpp WTA labels; the reference optionally refines
    with a graph-cut — the distance transform already places seams mid-
    overlap, which is what the cut converges to without strong gradients).
    Returns (H, W) int32, -1 where no view covers the pixel."""
    lab = torch.argmax(distance_weights(masks, sharpness), dim=0).to(torch.int32)
    return torch.where(torch.any(masks, dim=0), lab, torch.full_like(lab, -1))


def composite_with_labels(
    warped: torch.Tensor, labels: torch.Tensor, masks: torch.Tensor, levels: int = 5
) -> torch.Tensor:
    """Multi-band blend with hard seam labels (H, W) as the level-0 weights
    (laplacianCompositer.hpp with graph-cut seams)."""
    V = warped.shape[0]
    views = torch.arange(V, device=labels.device)[:, None, None]
    onehot = (labels[None] == views).to(torch.float32)
    return _covered(laplacian_blend(warped, onehot, levels=levels), masks)


def fill_holes(img: torch.Tensor, mask: torch.Tensor, iters: int = 50) -> torch.Tensor:
    """Diffusion inpainting of uncovered pixels (panoramaPostProcessing's
    fillHoles): repeated blur, with known pixels clamped each step."""
    out = torch.where(mask, img, torch.zeros_like(img))
    w = mask.to(torch.float32)
    for _ in range(iters):
        out_b = gaussian_blur(out, 2.0)
        w_b = gaussian_blur(w, 2.0)
        out = torch.where(mask, img, out_b / w_b.clamp(min=1e-6))
        w = torch.clamp(w_b * 4.0, 0.0, 1.0)
    return out


def crop_to_content(img, mask):
    """Tight bbox of covered pixels (host numpy mask) -> (img, mask,
    (y0, y1, x0, x1))."""
    m = np.asarray(mask)
    ys, xs = np.nonzero(m)
    if len(ys) == 0:
        return img, mask, (0, m.shape[0], 0, m.shape[1])
    y0, y1 = int(ys.min()), int(ys.max()) + 1
    x0, x1 = int(xs.min()), int(xs.max()) + 1
    return img[..., y0:y1, x0:x1], mask[y0:y1, x0:x1], (y0, y1, x0, x1)
