"""HDR bracket calibration and merging (port of `alicevision_tpu/hdr`)."""

from .calibration import (
    DebevecResponse,
    debevec_calibrate,
    grossberg_apply,
    grossberg_calibrate,
    laguerre_apply,
    laguerre_calibrate,
    sample_bracket_pixels,
    weight_gaussian,
    weight_triangle,
)
from .merge import estimate_brackets, merge_hdr

__all__ = [
    "DebevecResponse",
    "debevec_calibrate",
    "grossberg_apply",
    "grossberg_calibrate",
    "estimate_brackets",
    "laguerre_apply",
    "laguerre_calibrate",
    "merge_hdr",
    "sample_bracket_pixels",
    "weight_gaussian",
    "weight_triangle",
]
