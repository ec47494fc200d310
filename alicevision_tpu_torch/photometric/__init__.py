from .stereo import normal_integration_dct, photometric_stereo
from .lighting import augmented_normals, estimate_sh_lighting, render_sh

__all__ = [
    "augmented_normals",
    "estimate_sh_lighting",
    "normal_integration_dct",
    "photometric_stereo",
    "render_sh",
]
