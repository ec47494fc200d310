"""Carry state over from the JAX package without importing it.

The reference package hands its state across as plain Python and numpy:
`SgmParams._asdict()` / `SiftConfig._asdict()` for parameters,
`dataclasses.asdict(scene)` for an `SfMData` (numpy arrays, lists, dicts),
`dataclasses.asdict(config)` for an `IncrementalConfig`, a `BAProblem`
whose leaves went through `np.asarray`, a `VocTree` whose centers do,
`Tracks` as numpy arrays, and an incremental engine's host state. These
functions build the port's counterparts from such values. The `.sfm` and
`tracks.npz` files are the other carrier: a file that either package
writes loads in the other.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .camera import Intrinsics
from .device import resolve_device
from .features.sift import SiftConfig
from .matching.voctree import VocTree
from .mvs.plane_sweep import SgmParams
from .sfm.ba import BAProblem
from .sfm.incremental import IncrementalConfig, IncrementalSfM, _host_intrinsics
from .sfmdata.scene import SfMData
from .tracks.builder import Tracks


def sgm_params_from_reference(fields: dict) -> SgmParams:
    """SgmParams from the reference's `SgmParams._asdict()`."""
    unknown = set(fields) - set(SgmParams._fields)
    if unknown:
        raise ValueError(f"unknown SgmParams fields: {sorted(unknown)}")
    return SgmParams(**fields)


def sift_config_from_reference(fields: dict) -> SiftConfig:
    """SiftConfig from the reference's `SiftConfig._asdict()`."""
    unknown = set(fields) - set(SiftConfig._fields)
    if unknown:
        raise ValueError(f"unknown SiftConfig fields: {sorted(unknown)}")
    return SiftConfig(**fields)


def voctree_from_numpy(tree, device="cuda") -> VocTree:
    """The port's VocTree from the reference's (any object with `centers`,
    which `np.asarray` takes, `n_children` and `n_levels`): the
    (n_levels, max_nodes, D) centers copied onto `device` as float32."""
    centers = np.array(tree.centers, dtype=np.float32, copy=True)
    n_children, n_levels = int(tree.n_children), int(tree.n_levels)
    if centers.ndim != 3 or centers.shape[0] != n_levels or centers.shape[1] < n_children**n_levels:
        raise ValueError(f"centers {centers.shape} do not hold {n_levels} levels of {n_children}^l nodes")
    return VocTree(
        centers=torch.from_numpy(centers).to(resolve_device(device)),
        n_children=n_children,
        n_levels=n_levels,
    )


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


def incremental_config_from_reference(fields: dict) -> IncrementalConfig:
    """IncrementalConfig from the reference's `dataclasses.asdict(config)`."""
    names = {f.name for f in dataclasses.fields(IncrementalConfig)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown IncrementalConfig fields: {sorted(unknown)}")
    return IncrementalConfig(**fields)


def tracks_from_numpy(track_ids, views, features, n_tracks) -> Tracks:
    """The port's Tracks from the reference's arrays (copies, int32)."""
    arrays = [np.array(a, dtype=np.int32, copy=True) for a in (track_ids, views, features)]
    if not len(arrays[0]) == len(arrays[1]) == len(arrays[2]):
        raise ValueError(f"track arrays of lengths {[len(a) for a in arrays]}")
    return Tracks(*arrays, int(n_tracks))


# the host state of an incremental engine that its steps read and write
_ENGINE_RESULT = ("pose_R", "pose_c", "posed", "points", "point_valid")
_ENGINE_STATE = ("obs_inlier", "obs_norm", "_focal_mean")


def carry_engine_state(reference_engine, engine: IncrementalSfM) -> IncrementalSfM:
    """Copy a reference engine's host state into a port engine built over
    the same tracks and features: poses, points, validity, `obs_inlier`,
    the normalized observations and the refined intrinsics table. The two
    engines' next steps then start from the same state."""
    if reference_engine.T != engine.T or len(reference_engine.obs_track) != len(engine.obs_track):
        raise ValueError("the engines are built over different tracks")
    for name in _ENGINE_RESULT:
        setattr(engine.res, name, np.array(getattr(reference_engine.res, name), copy=True))
    engine.res.history = list(reference_engine.res.history)
    for name in _ENGINE_STATE:
        value = getattr(reference_engine, name)
        setattr(engine, name, float(value) if np.ndim(value) == 0 else np.array(value, copy=True))
    engine.intr_np = _host_intrinsics([getattr(reference_engine.intr_np, n) for n in Intrinsics._fields])
    return engine
