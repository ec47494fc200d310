from .scene import INVALID, SfMData
from .io import load, load_sfm, save, save_ply, save_sfm
from .colorize import colorize_tracks, npy_folder_loader

__all__ = [
    "INVALID",
    "SfMData",
    "colorize_tracks",
    "load",
    "load_sfm",
    "npy_folder_loader",
    "save",
    "save_ply",
    "save_sfm",
]
