from .checkerboard import detect_checkerboard, xcorner_response
from .zhang import calibrate_zhang, homography_dlt_planar

__all__ = [
    "calibrate_zhang",
    "detect_checkerboard",
    "homography_dlt_planar",
    "xcorner_response",
]
