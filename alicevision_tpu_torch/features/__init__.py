from . import io
from .sift import SiftConfig, SiftFeatures, extract as extract_sift, quantize_desc

__all__ = [
    "SiftConfig",
    "SiftFeatures",
    "extract_sift",
    "io",
    "quantize_desc",
]
