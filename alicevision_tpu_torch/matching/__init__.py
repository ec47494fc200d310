from .descriptor_matching import (
    Matches,
    guided_match_epipolar,
    make_hash_projection,
    match_bruteforce,
    match_cascade_hash,
    matches_to_pairs,
)
from . import voctree

__all__ = [
    "Matches",
    "guided_match_epipolar",
    "make_hash_projection",
    "match_bruteforce",
    "match_cascade_hash",
    "matches_to_pairs",
    "voctree",
]
