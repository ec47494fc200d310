from .ransac import (
    ACRansacSelection,
    acransac_select,
    lmeds_select,
    log10_choose,
    logalpha0_line,
    logalpha0_point,
    sample_minimal,
    simple_select,
)
from .estimators import (
    RobustModel,
    robust_fundamental,
    robust_fundamental_batch,
    robust_homography,
)

__all__ = [
    "ACRansacSelection",
    "RobustModel",
    "acransac_select",
    "lmeds_select",
    "log10_choose",
    "logalpha0_line",
    "logalpha0_point",
    "robust_fundamental",
    "robust_fundamental_batch",
    "robust_homography",
    "sample_minimal",
    "simple_select",
]
