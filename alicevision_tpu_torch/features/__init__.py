from . import io
from .akaze import AkazeConfig, extract as extract_akaze
from .markers import (
    MarkerDetection,
    detect_apriltags,
    detect_cctags,
    markers_to_features,
    render_apriltag,
    render_cctag,
)
from .sift import SiftConfig, SiftFeatures, extract as extract_sift, quantize_desc

__all__ = [
    "AkazeConfig",
    "MarkerDetection",
    "SiftConfig",
    "SiftFeatures",
    "detect_apriltags",
    "detect_cctags",
    "extract_akaze",
    "extract_sift",
    "io",
    "markers_to_features",
    "quantize_desc",
    "render_apriltag",
    "render_cctag",
]
