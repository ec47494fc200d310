"""Carry state over from the JAX package without importing it.

The reference package hands its state across as plain Python and numpy:
`SgmParams._asdict()` for the sweep parameters and
`dataclasses.asdict(scene)` for an `SfMData` (numpy arrays, lists, dicts).
These functions build the port's counterparts from such dicts. The `.sfm`
file is the other carrier: a file that either package writes loads in the
other.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np

from .mvs.plane_sweep import SgmParams
from .sfmdata.scene import SfMData


def sgm_params_from_reference(fields: dict) -> SgmParams:
    """SgmParams from the reference's `SgmParams._asdict()`."""
    unknown = set(fields) - set(SgmParams._fields)
    if unknown:
        raise ValueError(f"unknown SgmParams fields: {sorted(unknown)}")
    return SgmParams(**fields)


def scene_from_reference(fields: dict) -> SfMData:
    """SfMData from the reference's `dataclasses.asdict(scene)`: arrays are
    copied, lists and dicts deep-copied, so the two scenes share nothing."""
    names = {f.name for f in dataclasses.fields(SfMData)}
    missing = names - set(fields)
    unknown = set(fields) - names
    if missing or unknown:
        raise ValueError(
            f"SfMData fields: missing {sorted(missing)}, unknown {sorted(unknown)}"
        )
    return SfMData(
        **{
            k: np.array(v, copy=True) if isinstance(v, np.ndarray) else copy.deepcopy(v)
            for k, v in fields.items()
        }
    )
