"""Miscellaneous tools of the port: rig calibration, colour harmonization,
masking, segmentation, the colour checker and sphere detection."""

from .color_harmonization import harmonize_gains
from .masking import hsv_mask, threshold_mask
from .rig import average_quaternions, calibrate_rig

__all__ = ["average_quaternions", "calibrate_rig", "harmonize_gains", "hsv_mask", "threshold_mask"]
