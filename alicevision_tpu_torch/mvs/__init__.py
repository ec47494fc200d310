from .plane_sweep import (
    SgmParams,
    inverse_depth_planes,
    retrieve_best_depth,
    sgm_aggregate,
    sgm_depth_map,
    similarity_volume,
)
from .rectified import (
    rectification_ok,
    similarity_volume_auto,
    similarity_volume_rectified,
)
from .fusion import (
    consistency_filter,
    consistency_filter_ring,
    depth_range_from_landmarks,
    fuse_point_cloud,
)

__all__ = [
    "SgmParams",
    "consistency_filter",
    "consistency_filter_ring",
    "depth_range_from_landmarks",
    "fuse_point_cloud",
    "inverse_depth_planes",
    "rectification_ok",
    "retrieve_best_depth",
    "sgm_aggregate",
    "sgm_depth_map",
    "similarity_volume",
    "similarity_volume_auto",
    "similarity_volume_rectified",
]
