"""Carry state over from the JAX package without importing it.

The reference package hands its state across as plain Python and numpy:
`SgmParams._asdict()` for the sweep parameters,
`dataclasses.asdict(scene)` for an `SfMData` (numpy arrays, lists, dicts),
and a `BAProblem` whose leaves went through `np.asarray`. These functions
build the port's counterparts from such values. The `.sfm` file is the
other carrier: a file that either package writes loads in the other.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .camera import Intrinsics
from .device import resolve_device
from .mvs.plane_sweep import SgmParams
from .sfm.ba import BAProblem
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


def ba_problem_from_numpy(problem, device="cuda") -> BAProblem:
    """The port's BAProblem from the reference's: any object with the
    BAProblem fields (a NamedTuple whose leaves are numpy arrays, or arrays
    that `np.asarray` takes), its `intr` with the Intrinsics fields. Dtypes
    are kept (int32 tables, bool masks, float32 values); the tensors are
    copies on `device`."""
    dev = resolve_device(device)

    def tensor(x):
        return None if x is None else torch.from_numpy(np.array(x, copy=True)).to(dev)

    fields = {name: getattr(problem, name) for name in BAProblem._fields}
    unknown = set(getattr(problem, "_fields", BAProblem._fields)) - set(BAProblem._fields)
    if unknown:
        raise ValueError(f"unknown BAProblem fields: {sorted(unknown)}")
    intr = Intrinsics(*(tensor(getattr(fields["intr"], name)) for name in Intrinsics._fields))
    return BAProblem(**{k: intr if k == "intr" else tensor(v) for k, v in fields.items()})
