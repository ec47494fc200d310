from .selector import (
    block_flow_displacement,
    select_keyframes_regular,
    select_keyframes_smart,
    sharpness_score,
)

__all__ = [
    "block_flow_displacement",
    "select_keyframes_regular",
    "select_keyframes_smart",
    "sharpness_score",
]
