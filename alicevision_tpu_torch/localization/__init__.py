"""Camera localization against a reconstructed scene (landmark index,
vocabulary-tree retrieval, rig resection, markers)."""

from .localizer import LocalizationResult, build_landmark_index, localize_image, match_2d3d
from .marker_localizer import (
    SequenceRefineResult,
    localize_by_markers,
    localize_image_by_markers,
    refine_sequence,
)
from .voctree_localizer import RigLocalizationResult, VoctreeLocalizer, rig_resection

__all__ = [
    "LocalizationResult",
    "RigLocalizationResult",
    "SequenceRefineResult",
    "VoctreeLocalizer",
    "build_landmark_index",
    "localize_by_markers",
    "localize_image",
    "localize_image_by_markers",
    "match_2d3d",
    "refine_sequence",
    "rig_resection",
]
