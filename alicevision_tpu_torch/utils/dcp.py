"""DNG Camera Profile (DCP) support: parse + color transform.

A copy of `alicevision_tpu/utils/dcp.py` (ref: src/aliceVision/image/dcp.hpp,
dcp.cpp — parses Adobe DCP profiles and builds the camera-RGB -> ACES/sRGB
transform with dual illuminant interpolation). The reference reads the
binary TIFF-tag DCP container; this reads the XML form emitted by Adobe's
dcpTool (the same fields, documented in the DNG spec): ColorMatrix1/2,
ForwardMatrix1/2, CalibrationIlluminant1/2, ProfileToneCurve.

The transform math is the DNG spec's: interpolate matrices between the two
calibration illuminants by inverse correlated color temperature, then
camera -> XYZ(D50) via the forward matrix and XYZ -> linear sRGB. Parsing
and the matrices are host numpy; `apply` is one 3x3 product over the image
in torch, on the image's device.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET

import numpy as np

# EXIF LightSource -> correlated color temperature (the subset DCPs use;
# same table the reference keys on, image/dcp.cpp calibrationIlluminant).
_ILLUMINANT_CCT = {
    17: 2856.0,  # Standard light A
    18: 4874.0,  # B
    19: 6774.0,  # C
    20: 5500.0,  # D55
    21: 6500.0,  # D65
    22: 7500.0,  # D75
    23: 5000.0,  # D50
    1: 5500.0,  # daylight
    2: 4200.0,  # fluorescent
    3: 2850.0,  # tungsten
    10: 6000.0,  # flash (approx)
}

_XYZ_TO_SRGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ]
)

# Bradford adaptation D50 -> D65 (sRGB's white), DNG spec appendix.
_D50_TO_D65 = np.array(
    [
        [0.9555766, -0.0230393, 0.0631636],
        [-0.0282895, 1.0099416, 0.0210077],
        [0.0122982, -0.0204830, 1.3299098],
    ]
)


class DCPProfile:
    def __init__(
        self,
        name: str = "",
        color_matrix_1: np.ndarray | None = None,
        color_matrix_2: np.ndarray | None = None,
        forward_matrix_1: np.ndarray | None = None,
        forward_matrix_2: np.ndarray | None = None,
        illuminant_1: int = 17,
        illuminant_2: int = 21,
        tone_curve: np.ndarray | None = None,  # (N, 2) (in, out) pairs
    ):
        self.name = name
        self.color_matrix_1 = color_matrix_1
        self.color_matrix_2 = color_matrix_2
        self.forward_matrix_1 = forward_matrix_1
        self.forward_matrix_2 = forward_matrix_2
        self.illuminant_1 = illuminant_1
        self.illuminant_2 = illuminant_2
        self.tone_curve = tone_curve

    # -- parsing -----------------------------------------------------------
    @staticmethod
    def from_xml(path_or_text: str) -> "DCPProfile":
        """Parse the dcpTool XML form of a DCP."""
        if "<" in path_or_text:
            root = ET.fromstring(path_or_text)
        else:
            root = ET.parse(path_or_text).getroot()

        def matrix(tag):
            el = root.find(tag)
            if el is None:
                return None
            vals = {}
            for e in el.iter("Element"):
                vals[(int(e.get("Row")), int(e.get("Col")))] = float(e.text)
            if vals:
                m = np.zeros((3, 3))
                for (r, c), x in vals.items():
                    m[r, c] = x
                return m
            # space-separated fallback
            nums = [float(x) for x in re.findall(r"-?\d+\.?\d*(?:[eE]-?\d+)?", el.text or "")]
            return np.array(nums).reshape(3, 3) if len(nums) == 9 else None

        def text_int(tag, default):
            el = root.find(tag)
            return int(el.text) if el is not None and el.text else default

        tone = None
        tc = root.find("ProfileToneCurve")
        if tc is not None:
            nums = [float(x) for x in re.findall(r"-?\d+\.?\d*(?:[eE]-?\d+)?", " ".join(e.text or "" for e in tc.iter()))]
            if len(nums) >= 4:
                tone = np.array(nums).reshape(-1, 2)

        name_el = root.find("ProfileName")
        return DCPProfile(
            name=name_el.text if name_el is not None else "",
            color_matrix_1=matrix("ColorMatrix1"),
            color_matrix_2=matrix("ColorMatrix2"),
            forward_matrix_1=matrix("ForwardMatrix1"),
            forward_matrix_2=matrix("ForwardMatrix2"),
            illuminant_1=text_int("CalibrationIlluminant1", 17),
            illuminant_2=text_int("CalibrationIlluminant2", 21),
            tone_curve=tone,
        )

    # -- transform ---------------------------------------------------------
    def interpolated_matrix(self, cct: float, which: str = "forward") -> np.ndarray:
        """DNG dual-illuminant interpolation: linear in 1/CCT between the two
        calibration illuminants (dcp.cpp getInterpolatedMatrix)."""
        m1 = getattr(self, f"{which}_matrix_1")
        m2 = getattr(self, f"{which}_matrix_2")
        if m1 is None:
            return m2
        if m2 is None:
            return m1
        t1 = _ILLUMINANT_CCT.get(self.illuminant_1, 2856.0)
        t2 = _ILLUMINANT_CCT.get(self.illuminant_2, 6500.0)
        cct = float(np.clip(cct, min(t1, t2), max(t1, t2)))
        if abs(1 / t1 - 1 / t2) < 1e-12:
            w = 0.5
        else:
            w = (1 / cct - 1 / t2) / (1 / t1 - 1 / t2)
        return w * m1 + (1 - w) * m2

    def camera_to_srgb_matrix(self, cct: float = 5000.0) -> np.ndarray:
        """Full linear transform camera RGB -> linear sRGB(D65)."""
        fwd = self.interpolated_matrix(cct, "forward")
        if fwd is None:
            raise ValueError("profile has no forward matrices")
        return _XYZ_TO_SRGB @ _D50_TO_D65 @ fwd

    def apply(self, img, cct: float = 5000.0, apply_tone_curve: bool = False):
        """Apply the profile to an (H, W, 3) camera-RGB image (numpy or a
        tensor) -> float32 tensor on the image's device (the CPU for
        numpy)."""
        import torch

        x = torch.as_tensor(img, dtype=torch.float32)
        M = torch.as_tensor(self.camera_to_srgb_matrix(cct), dtype=torch.float32, device=x.device)
        out = torch.einsum("ij,hwj->hwi", M, x)
        if apply_tone_curve and self.tone_curve is not None:
            xs = torch.as_tensor(self.tone_curve[:, 0], dtype=torch.float32, device=x.device)
            ys = torch.as_tensor(self.tone_curve[:, 1], dtype=torch.float32, device=x.device)
            out = _interp(torch.clamp(out, 0.0, 1.0), xs, ys)
        return out


def _interp(x, xs, ys):
    """`numpy.interp` on a tensor: piecewise linear through (xs, ys), xs
    increasing, clamped to ys[0] / ys[-1] outside [xs[0], xs[-1]]."""
    import torch

    i = torch.clamp(torch.searchsorted(xs, x.contiguous(), right=True), 1, len(xs) - 1)
    x0, x1, y0, y1 = xs[i - 1], xs[i], ys[i - 1], ys[i]
    t = (x - x0) / torch.where(x1 > x0, x1 - x0, torch.ones_like(x1))
    y = y0 + t * (y1 - y0)
    return torch.where(x <= xs[0], ys[0], torch.where(x >= xs[-1], ys[-1], y))
