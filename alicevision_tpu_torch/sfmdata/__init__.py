from .scene import INVALID, SfMData
from .io import load, load_sfm, save, save_sfm

__all__ = ["INVALID", "SfMData", "load", "load_sfm", "save", "save_sfm"]
