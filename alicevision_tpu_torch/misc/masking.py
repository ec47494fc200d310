"""Image masking helpers (HSV / threshold).

Port of `alicevision_tpu/misc/masking.py`, on the device of the tensors it
is given. Counterpart of the reference's imageMasking module
(ref: src/aliceVision/imageMasking/imageMasking.cpp — HSV range masks used
by main_imageMasking.cpp). Elementwise math on (H, W, 3) tensors, a
256-bin histogram for Otsu's threshold and 3x3 morphology.

Otsu's histogram counts in integers (`bincount`): the JAX package adds 1.0
in float32, which stops counting past 2**24 pixels in one bin (ROADMAP §3).
The between-class variances are taken in float64, so the card and the CPU
pick the same bin.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = mx - mn
    tiny = diff.new_tensor(1e-9)
    safe = torch.where(diff < 1e-9, tiny, diff)
    h = torch.where(
        mx == r,
        torch.remainder((g - b) / safe, 6.0),
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0),
    )
    h = torch.where(diff < 1e-9, torch.zeros_like(h), h) / 6.0
    s = torch.where(mx < 1e-9, torch.zeros_like(mx), diff / torch.where(mx < 1e-9, tiny, mx))
    return torch.stack([h, s, mx], dim=-1)


def hsv_mask(
    rgb: torch.Tensor,
    h_range=(0.0, 1.0),
    s_range=(0.0, 1.0),
    v_range=(0.0, 1.0),
    invert: bool = False,
) -> torch.Tensor:
    """Boolean mask of pixels inside the HSV box. Hue wraps around."""
    hsv = rgb_to_hsv(rgb)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h0, h1 = h_range
    if h0 <= h1:
        h_ok = (h >= h0) & (h <= h1)
    else:  # wrap-around range (e.g. reds)
        h_ok = (h >= h0) | (h <= h1)
    m = h_ok & (s >= s_range[0]) & (s <= s_range[1]) & (v >= v_range[0]) & (v <= v_range[1])
    return ~m if invert else m


def threshold_mask(gray: torch.Tensor, lo: float = 0.05, hi: float = 0.95) -> torch.Tensor:
    return (gray >= lo) & (gray <= hi)


def otsu_threshold(gray: torch.Tensor, n_bins: int = 256) -> torch.Tensor:
    """Otsu's between-class-variance-maximizing threshold (a 0-d tensor in
    gray's dtype).

    Counterpart of the reference's autoGrayscaleThreshold
    (ref: src/aliceVision/imageMasking/imageMasking.hpp:46) — an integer
    histogram and an argmax over candidate thresholds, on the device.
    """
    g = torch.clamp(gray, 0.0, 1.0).reshape(-1)
    idx = torch.clamp((g * n_bins).to(torch.int32), 0, n_bins - 1)
    hist = torch.bincount(idx, minlength=n_bins).to(torch.float64)
    p = hist / torch.clamp(hist.sum(), min=1.0)
    centers = (torch.arange(n_bins, device=gray.device, dtype=torch.float64) + 0.5) / n_bins
    w0 = torch.cumsum(p, 0)
    mu = torch.cumsum(p * centers, 0)
    mu_t = mu[-1]
    w1 = 1.0 - w0
    safe = torch.clamp(w0 * w1, min=1e-12)
    between = (mu_t * w0 - mu) ** 2 / safe
    return centers[torch.argmax(between)].to(gray.dtype)


def auto_threshold_mask(gray: torch.Tensor) -> torch.Tensor:
    """Foreground = pixels above the Otsu threshold."""
    return gray >= otsu_threshold(gray)


def _morph(mask: torch.Tensor, iterations: int, maximum: bool) -> torch.Tensor:
    """3x3 binary dilation/erosion (iterated): `max_pool2d` over a -inf
    border, erosion as its dual — `reduce_window(..., "SAME")` with the
    max's or the min's identity as the border."""
    x = mask.to(torch.float32)[None, None]
    if not maximum:
        x = -x
    for _ in range(max(0, iterations)):
        x = F.max_pool2d(F.pad(x, (1, 1, 1, 1), value=float("-inf")), 3, stride=1)
    if not maximum:
        x = -x
    return x[0, 0] > 0.5


def dilate(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Grow the selected area (ref imageMasking.hpp:66 postprocess_dilate;
    the CLI's growRadius)."""
    return _morph(mask, iterations, maximum=True)


def erode(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Shrink the selected area (ref imageMasking.hpp:73 postprocess_erode;
    the CLI's shrinkRadius)."""
    return _morph(mask, iterations, maximum=False)


def closing(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Dilate then erode — fills holes up to ~iterations px
    (ref imageMasking.hpp:59 postprocess_closing)."""
    return erode(dilate(mask, iterations), iterations)
