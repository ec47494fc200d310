from .epipolar import (
    decompose_essential,
    epipolar_distance_sq,
    essential_8pt,
    essential_from_F,
    fundamental_7pt,
    fundamental_8pt,
    fundamental_10pt,
    homography_4pt,
    homography_error_sq,
    normalize_points,
    relative_pose_from_essential,
    select_cheirality,
)

__all__ = [
    "decompose_essential",
    "epipolar_distance_sq",
    "essential_8pt",
    "essential_from_F",
    "fundamental_7pt",
    "fundamental_8pt",
    "fundamental_10pt",
    "homography_4pt",
    "homography_error_sq",
    "normalize_points",
    "relative_pose_from_essential",
    "select_cheirality",
]
