"""Color-space conversions: sRGB / linear / REC709 / ACES / XYZ / CIELAB.

Port of `alicevision_tpu/image/colorspace.py` (ref:
src/aliceVision/image/colorspace.hpp:23-49 EImageColorSpace, io.cpp color
conversion on read/write; the CIELAB conversion of
depthMap/cuda/imageProcessing/deviceColorConversion.cu rgb2lab).
Elementwise torch over (..., 3) tensors in [0, 1] (linear spaces
unbounded), on the tensor's device; the matrices follow its dtype.

Camera-vendor log curves (ARRI LogC, RED Log3G10, Sony S-Log3, ...) need
the vendors' OCIO configs, which are not shipped; `convert` accepts their
names and raises a clear error pointing at the OCIO route, as the
reference defers to OIIO/OCIO.
"""

from __future__ import annotations

import torch

# Rec.709 / sRGB primaries, D65 white (same matrix; transfer differs).
_RGB_TO_XYZ = torch.tensor(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ]
)
_XYZ_TO_RGB = torch.tensor(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ]
)
# ACES2065-1 (AP0) and ACEScg (AP1), both D60, via the official CTL matrices.
_AP0_TO_XYZ = torch.tensor(
    [
        [0.9525523959, 0.0000000000, 0.0000936786],
        [0.3439664498, 0.7281660966, -0.0721325464],
        [0.0000000000, 0.0000000000, 1.0088251844],
    ]
)
_XYZ_TO_AP0 = torch.tensor(
    [
        [1.0498110175, 0.0000000000, -0.0000974845],
        [-0.4959030231, 1.3733130458, 0.0982400361],
        [0.0000000000, 0.0000000000, 0.9912520182],
    ]
)
_AP1_TO_XYZ = torch.tensor(
    [
        [0.6624541811, 0.1340042065, 0.1561876870],
        [0.2722287168, 0.6740817658, 0.0536895174],
        [-0.0055746495, 0.0040607335, 1.0103391003],
    ]
)
_XYZ_TO_AP1 = torch.tensor(
    [
        [1.6410233797, -0.3248032942, -0.2364246952],
        [-0.6636628587, 1.6153315917, 0.0167563477],
        [0.0117218943, -0.0082844420, 0.9883948585],
    ]
)

# D65 reference white for Lab
_WHITE_D65 = torch.tensor([0.95047, 1.0, 1.08883])


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """sRGB electro-optical transfer (IEC 61966-2-1)."""
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, min=0.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1 / 2.4) - 0.055)


def rec709_to_linear(c: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.709 OETF inverse."""
    return torch.where(c < 0.081, c / 4.5, ((c + 0.099) / 1.099) ** (1 / 0.45))


def linear_to_rec709(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, min=0.0)
    return torch.where(c < 0.018, c * 4.5, 1.099 * c**0.45 - 0.099)


def _mat(m, rgb):
    return torch.einsum("ij,...j->...i", m.to(device=rgb.device, dtype=rgb.dtype), rgb)


def linear_rgb_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
    return _mat(_RGB_TO_XYZ, rgb)


def xyz_to_linear_rgb(xyz: torch.Tensor) -> torch.Tensor:
    return _mat(_XYZ_TO_RGB, xyz)


def xyz_to_lab(xyz: torch.Tensor) -> torch.Tensor:
    """CIE 1976 L*a*b*, D65 white. L in [0, 100]."""
    t = xyz / _WHITE_D65.to(device=xyz.device, dtype=xyz.dtype)
    d = 6.0 / 29.0
    f = torch.where(t > d**3, torch.clamp(t, min=1e-12) ** (1.0 / 3.0), t / (3 * d * d) + 4.0 / 29.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([L, a, b], dim=-1)


def lab_to_xyz(lab: torch.Tensor) -> torch.Tensor:
    d = 6.0 / 29.0
    fy = (lab[..., 0] + 16.0) / 116.0
    fx = fy + lab[..., 1] / 500.0
    fz = fy - lab[..., 2] / 200.0
    f = torch.stack([fx, fy, fz], dim=-1)
    t = torch.where(f > d, f**3, 3 * d * d * (f - 4.0 / 29.0))
    return t * _WHITE_D65.to(device=lab.device, dtype=lab.dtype)


def linear_rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """The conversion the reference's SGM similarity runs on the GPU
    (deviceColorConversion.cu): linear RGB -> CIELAB."""
    return xyz_to_lab(linear_rgb_to_xyz(rgb))


def lab_to_linear_rgb(lab: torch.Tensor) -> torch.Tensor:
    return xyz_to_linear_rgb(lab_to_xyz(lab))


# name -> (to_linear_rec709_rgb, from_linear_rec709_rgb); linear working
# space is Rec.709/sRGB-primaries linear, like the reference's "LINEAR".
_UNSUPPORTED = {
    "arri_logc3", "arri_logc4", "linear_arri_wide_gamut_3",
    "linear_arri_wide_gamut_4", "linear_bmd_widegamut_gen5",
    "bmdfilm_widegamut_gen5", "canonlog2_cinemagamut_d55",
    "canonlog3_cinemagamut_d55", "linear_cinemagamut_d55",
    "linear_v_gamut", "v_log_v_gamut", "linear_redwidegamutrgb",
    "log3g10_redwidegamutrgb", "linear_venice_s_gamut3_cine",
    "s_log3_venice_s_gamut3_cine",
}


def convert(img: torch.Tensor, src: str, dst: str) -> torch.Tensor:
    """Convert (..., 3) between named color spaces
    (ref: image/colorspace.hpp EImageColorSpace names, case-insensitive).

    Supported: linear, srgb, rec709, aces2065-1, acescg, xyz, lab,
    no_conversion/auto (identity).
    """
    s, d = src.lower().replace("-", "_"), dst.lower().replace("-", "_")
    alias = {"aces2065_1": "aces2065_1", "aces": "aces2065_1"}
    s = alias.get(s, s)
    d = alias.get(d, d)
    for name in (s, d):
        if name in _UNSUPPORTED:
            raise ValueError(
                f"color space '{name}' needs the vendor's OCIO config, which "
                "this environment does not ship; convert externally (the "
                "reference defers to OIIO/OCIO for these too)"
            )
    if s == d or s in ("no_conversion", "auto") or d in ("no_conversion", "auto"):
        return img

    to_lin = {
        "linear": lambda x: x,
        "srgb": srgb_to_linear,
        "rec709": rec709_to_linear,
        "aces2065_1": lambda x: xyz_to_linear_rgb(_mat(_AP0_TO_XYZ, x)),
        "acescg": lambda x: xyz_to_linear_rgb(_mat(_AP1_TO_XYZ, x)),
        "xyz": xyz_to_linear_rgb,
        "lab": lab_to_linear_rgb,
    }
    from_lin = {
        "linear": lambda x: x,
        "srgb": linear_to_srgb,
        "rec709": linear_to_rec709,
        "aces2065_1": lambda x: _mat(_XYZ_TO_AP0, linear_rgb_to_xyz(x)),
        "acescg": lambda x: _mat(_XYZ_TO_AP1, linear_rgb_to_xyz(x)),
        "xyz": linear_rgb_to_xyz,
        "lab": linear_rgb_to_lab,
    }
    if s not in to_lin:
        raise ValueError(f"unknown color space: {src}")
    if d not in from_lin:
        raise ValueError(f"unknown color space: {dst}")
    return from_lin[d](to_lin[s](img))
