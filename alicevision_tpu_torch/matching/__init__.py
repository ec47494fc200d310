from .descriptor_matching import (
    Matches,
    guided_match_epipolar,
    make_hash_projection,
    match_bruteforce,
    match_cascade_hash,
    matches_to_pairs,
)
from .hgrowing import HGrowingParams, filter_matches_hgrowing, grow_from_seeds
from .photometric_filter import photometric_filter
from . import voctree

__all__ = [
    "Matches",
    "guided_match_epipolar",
    "make_hash_projection",
    "match_bruteforce",
    "match_cascade_hash",
    "matches_to_pairs",
    "photometric_filter",
    "voctree",
    "HGrowingParams",
    "filter_matches_hgrowing",
    "grow_from_seeds",
]
