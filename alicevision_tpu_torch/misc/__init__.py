"""Miscellaneous tools of the port: rig calibration (the JAX package's
colour harmonization and masking are not ported yet, ROADMAP item 13)."""

from .rig import average_quaternions, calibrate_rig

__all__ = ["average_quaternions", "calibrate_rig"]
