"""The panorama pipeline (port of `alicevision_tpu/panorama`): spherical
warping, distance seams with multi-band compositing, and graph-cut seams
(`graphcut_seams.py`, host numpy over the port's C++ max-flow)."""

from .warping import (
    direction_to_equirect,
    equirect_to_direction,
    warp_to_equirect,
)
from .compositing import (
    distance_weights,
    laplacian_blend,
    composite_panorama,
)

__all__ = [
    "composite_panorama",
    "direction_to_equirect",
    "distance_weights",
    "equirect_to_direction",
    "laplacian_blend",
    "warp_to_equirect",
]
