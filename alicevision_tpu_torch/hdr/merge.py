"""HDR bracket merging with highlight handling.

Port of `alicevision_tpu/hdr/merge.py` (ref: src/aliceVision/hdr/hdrMerge.cpp
— weighted average of linearized brackets divided by exposure, with
highlight recovery from the shortest exposure; brackets.cpp — exposure
grouping, host code). Batched tensor math on the images' device.
"""

from __future__ import annotations

import numpy as np
import torch

from .calibration import grossberg_apply, laguerre_inverse, weight_gaussian


def estimate_brackets(exposures: np.ndarray, n_brackets: int) -> list:
    """Group a sorted exposure sequence into bracket groups
    (hdr/brackets.cpp: consecutive runs of n_brackets)."""
    n = len(exposures)
    return [list(range(s, s + n_brackets)) for s in range(0, n - n_brackets + 1, n_brackets)]


def merge_hdr(
    images: torch.Tensor,  # (B, H, W[, C]) in [0, 1]
    exposures: torch.Tensor,  # (B,)
    phi=0.0,  # Laguerre response parameter (0 = linear)
    highlight_rescale: bool = True,
    response: tuple | None = None,  # ("laguerre", phi) | ("grossberg", c) | ("debevec", g)
) -> torch.Tensor:
    """Radiance map: sum_b w(z_b) lin(z_b)/dt_b / sum_b w(z_b).

    Saturated-everywhere pixels fall back to the shortest exposure's
    linearized value (highlight recovery). The inverse response defaults to
    the Laguerre family (phi); a precomputed curve from ldrToHdrCalibration
    can be passed via `response` (its parameter as numpy or a tensor)."""
    dev, dt = images.device, images.dtype
    if response is not None:
        kind, param = response
        param = torch.as_tensor(param, dtype=dt, device=dev)
        if kind == "laguerre":
            lin = laguerre_inverse(param, images)
        elif kind == "grossberg":
            lin = grossberg_apply(param, images)
        elif kind == "debevec":
            # g[z] = ln E + ln dt: exponentiate the tabulated log response.
            n_levels = param.shape[0]
            z = torch.clamp((images * (n_levels - 1)).to(torch.int64), 0, n_levels - 1)
            lin = torch.exp(param[z])
        else:  # pragma: no cover
            raise ValueError(f"unknown response kind {kind!r}")
    else:
        lin = laguerre_inverse(torch.as_tensor(phi, dtype=dt, device=dev), images)
    shape = [-1] + [1] * (images.ndim - 1)
    dt_b = exposures.reshape(shape)
    w = weight_gaussian(images)
    # exclude fully saturated / fully dark from the weighting
    w = torch.where((images > 0.995) | (images < 0.005), torch.zeros_like(w), w)
    num = torch.sum(w * lin / dt_b, dim=0)
    den = torch.sum(w, dim=0)

    shortest = torch.argmin(exposures).reshape(1)
    fallback = (lin.index_select(0, shortest) / exposures.index_select(0, shortest).reshape(shape))[0]
    merged = torch.where(den > 1e-6, num / torch.clamp(den, min=1e-6), fallback)

    if highlight_rescale:
        # saturated in ALL brackets -> clamp to the brightest recoverable
        # radiance to avoid magenta-style blowouts
        all_sat = torch.all(images > 0.995, dim=0)
        merged = torch.where(all_sat, torch.maximum(merged, fallback), merged)
    return merged


def highlight_recovery(
    radiance: torch.Tensor,  # (H, W[, C]) merged radiance
    brightest_ldr: torch.Tensor,  # (H, W[, C]) most-exposed LDR in [0, 1]
    target_exposure: float,
    correction_factor: float = 1.0,
    target_lux: float = 120000.0,
) -> torch.Tensor:
    """Clamped-highlight compensation (ref: hdrMerge.cpp:199-272).

    Per pixel, a soft clamped-ness score from the most-exposed LDR
    (inverse sigmoid around 0.95, width 0.08, hdrMerge.cpp:39-42) is
    averaged over channels, Gaussian-smoothed, and used to blend the
    radiance toward highlightTarget = target_lux * target_exposure * 2.5
    wherever the merged radiance is below that target.
    """
    if correction_factor == 0.0:
        return radiance
    from ..image.filtering import gaussian_blur_conv

    target = target_lux * target_exposure * 2.5
    clamped = 1.0 / (1.0 + torch.exp(10.0 * ((0.95 - brightest_ldr) / 0.08)))
    if clamped.ndim == 3:
        clamped = torch.mean(clamped, dim=-1)
    comp = torch.clamp(correction_factor * gaussian_blur_conv(clamped, 1.0), 0.0, 1.0)
    comp = comp[..., None] if radiance.ndim == 3 else comp
    recovered = comp * target + (1.0 - comp) * radiance
    return torch.where(radiance < target, recovered, radiance)
