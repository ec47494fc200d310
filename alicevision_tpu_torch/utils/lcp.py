"""Adobe Lens Correction Profile (LCP) parsing (a copy of
`alicevision_tpu/utils/lcp.py`, host code).

Counterpart of the reference's lensCorrectionProfile module
(ref: src/aliceVision/lensCorrectionProfile/lcp.cpp — expat-based parser of
the Adobe LCP XMP schema, used to seed distortion/vignetting priors). Uses
the stdlib XML parser; extracts the rectilinear geometry model parameters
per (focal length, focus distance) alternate and provides interpolation to
a query focal length.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field


@dataclass
class LcpAlternate:
    focal_mm: float = 0.0
    focal_x: float = 0.0  # normalized focal (FocalLengthX)
    focal_y: float = 0.0
    cx: float = 0.5  # ImageXCenter
    cy: float = 0.5
    radial: tuple = (0.0, 0.0, 0.0)  # RadialDistortParam1..3
    vignette: tuple = ()


@dataclass
class LcpProfile:
    camera: str = ""
    lens: str = ""
    alternates: list = field(default_factory=list)

    def interpolate(self, focal_mm: float) -> LcpAlternate:
        """Pick/interpolate the model for a focal length (lcp.cpp behavior:
        linear blend between bracketing alternates)."""
        alts = sorted(self.alternates, key=lambda a: a.focal_mm)
        if not alts:
            raise ValueError("empty LCP profile")
        if focal_mm <= alts[0].focal_mm:
            return alts[0]
        if focal_mm >= alts[-1].focal_mm:
            return alts[-1]
        for lo, hi in zip(alts, alts[1:]):
            if lo.focal_mm <= focal_mm <= hi.focal_mm:
                t = (focal_mm - lo.focal_mm) / max(hi.focal_mm - lo.focal_mm, 1e-9)
                mix = lambda a, b: a + t * (b - a)
                return LcpAlternate(
                    focal_mm=focal_mm,
                    focal_x=mix(lo.focal_x, hi.focal_x),
                    focal_y=mix(lo.focal_y, hi.focal_y),
                    cx=mix(lo.cx, hi.cx),
                    cy=mix(lo.cy, hi.cy),
                    radial=tuple(
                        mix(a, b) for a, b in zip(lo.radial, hi.radial)
                    ),
                    vignette=tuple(
                        mix(a, b) for a, b in zip(lo.vignette, hi.vignette)
                    )
                    if len(lo.vignette) == len(hi.vignette)
                    else lo.vignette or hi.vignette,
                )
        return alts[0]


def _local(tag: str) -> str:
    return tag.split("}")[-1]


def _get_attr(elem, name):
    for k, v in elem.attrib.items():
        if _local(k) == name:
            return v
    return None


def parse_lcp(path: str) -> LcpProfile:
    tree = ET.parse(path)
    root = tree.getroot()
    prof = LcpProfile()

    def walk(elem):
        tag = _local(elem.tag)
        if tag == "Description":
            model = _get_attr(elem, "Model") or _get_attr(elem, "CameraPrettyName")
            if model and not prof.camera:
                prof.camera = model
            lens = _get_attr(elem, "Lens") or _get_attr(elem, "LensPrettyName")
            if lens and not prof.lens:
                prof.lens = lens
            fl = _get_attr(elem, "FocalLength")
            fx = _get_attr(elem, "FocalLengthX")
            if fx is not None:
                alt = LcpAlternate(
                    focal_mm=float(fl or 0.0),
                    focal_x=float(fx),
                    focal_y=float(_get_attr(elem, "FocalLengthY") or fx),
                    cx=float(_get_attr(elem, "ImageXCenter") or 0.5),
                    cy=float(_get_attr(elem, "ImageYCenter") or 0.5),
                    radial=(
                        float(_get_attr(elem, "RadialDistortParam1") or 0.0),
                        float(_get_attr(elem, "RadialDistortParam2") or 0.0),
                        float(_get_attr(elem, "RadialDistortParam3") or 0.0),
                    ),
                )
                v1 = _get_attr(elem, "VignetteModelParam1")
                if v1 is not None:
                    alt.vignette = (
                        float(v1),
                        float(_get_attr(elem, "VignetteModelParam2") or 0.0),
                        float(_get_attr(elem, "VignetteModelParam3") or 0.0),
                    )
                prof.alternates.append(alt)
        for child in elem:
            walk(child)

    walk(root)
    return prof
