"""WGS84 GPS conversions, a host copy of `alicevision_tpu/geometry/gps.py`
(ref: src/aliceVision/numeric/gps.cpp:14-35 WGS84ToCartesian, :37-50
parseAltitudeFromString, :52-76 parseGPSFromString). Same ellipsoid constants and EXIF string conventions
as the reference, vectorized over leading axes."""

from __future__ import annotations

import numpy as np

_EQU_RADIUS = 6378137.0  # WGS84 major axis
_FLATTENING = 1.0 / 298.257222101
_SQR_ECC = _FLATTENING * (2.0 - _FLATTENING)


def wgs84_to_cartesian(llh) -> np.ndarray:
    """(lat deg, lon deg, alt m) -> ECEF (x, y, z) meters. llh: (..., 3)."""
    llh = np.asarray(llh, np.float64)
    lat = np.radians(llh[..., 0])
    lon = np.radians(llh[..., 1])
    alt = llh[..., 2]
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    n = _EQU_RADIUS / np.sqrt(1.0 - _SQR_ECC * sin_lat * sin_lat)
    return np.stack(
        [
            (n + alt) * cos_lat * np.cos(lon),
            (n + alt) * cos_lat * np.sin(lon),
            (n * (1.0 - _SQR_ECC) + alt) * sin_lat,
        ],
        axis=-1,
    )


def parse_altitude_from_string(alt: str, alt_ref: str) -> float:
    """EXIF GPSAltitude + GPSAltitudeRef ('1' = below sea level)."""
    if alt_ref not in ("0", "1"):
        raise ValueError(f"Unexpected gps altitude reference: {alt_ref!r}")
    a = float(_ratio(alt))
    return -a if float(alt_ref) > 0 else a


def parse_gps_from_string(gps_degrees: str, gps_ref: str) -> float:
    """EXIF 'd, m, s' rational triplet + N/S/E/W ref -> decimal degrees."""
    if gps_ref not in ("N", "S", "E", "W"):
        raise ValueError(f"Unexpected gps reference: {gps_ref!r}")
    parts = [p.strip() for p in gps_degrees.split(",")]
    deg = 0.0
    for i, p in enumerate(parts[:3]):
        deg += _ratio(p) / (60.0**i)
    if gps_ref in ("S", "W"):
        deg = -deg
    return deg


def _ratio(s: str) -> float:
    if "/" in s:
        num, den = s.split("/")
        return float(num) / float(den)
    return float(s)
