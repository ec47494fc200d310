"""Cross-scene transfer of poses / intrinsics, and regression comparison.

Host copy of `alicevision_tpu/sfm/transfer.py`, the counterparts of the
reference's scene-surgery utilities
(ref: src/software/utils/main_sfmTransfer.cpp — copy poses/intrinsics
between scenes matched by view id or filename;
src/software/utils/main_applyCalibration.cpp — overwrite intrinsics from a
calibrated scene; src/software/utils/main_sfmRegression.cpp — numeric
comparison of two reconstructions). Host array surgery on the scene's
flat arrays; nothing here needs a device.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .. import camera as cam
from ..sfmdata.scene import INVALID, SfMData


def _view_key(scene: SfMData, v: int, by: str):
    if by == "filename":
        return os.path.basename(scene.view_paths[v])
    return int(scene.view_ids[v])


def transfer_poses(dst: SfMData, src: SfMData, match_by: str = "viewId") -> int:
    """Copy poses of views present in both scenes (matched by id or
    filename). Returns the number of poses transferred
    (ref: main_sfmTransfer.cpp `--transferPoses`)."""
    index = {
        _view_key(src, v, match_by): v
        for v in src.valid_views()
    }
    n = 0
    for v in range(dst.n_views):
        s = index.get(_view_key(dst, v, match_by))
        if s is None:
            continue
        p = int(src.view_pose[s])
        dst.set_pose(v, src.pose_R[p].copy(), src.pose_c[p].copy())
        n += 1
    return n


def transfer_intrinsics(dst: SfMData, src: SfMData, match_by: str = "viewId") -> int:
    """Copy the intrinsic parameters (focal/offset/distortion) used by
    matching views. The destination keeps its own intrinsics table layout;
    only parameter values are overwritten
    (ref: main_sfmTransfer.cpp `--transferIntrinsics`)."""
    index = {_view_key(src, v, match_by): v for v in range(src.n_views)}
    touched = set()
    n = 0
    for v in range(dst.n_views):
        s = index.get(_view_key(dst, v, match_by))
        if s is None:
            continue
        di = int(dst.view_intrinsic[v])
        si = int(src.view_intrinsic[s])
        if di == INVALID or si == INVALID or di in touched:
            continue
        touched.add(di)
        dst.cam_kind[di] = src.cam_kind[si]
        dst.disto_kind[di] = src.disto_kind[si]
        dst.scale[di] = src.scale[si]
        dst.offset[di] = src.offset[si]
        dst.disto[di] = src.disto[si]
        n += 1
    return n


def apply_calibration(dst: SfMData, calib_path: str) -> int:
    """Apply a calibration file to every intrinsic of the scene.

    Accepts either a checkerboardCalibration JSON ({"K": 3x3, "dist": [...]})
    or a calibrated .sfm scene (ref: main_applyCalibration.cpp — replaces
    intrinsics with the calibrated ones, rescaled to each view's size)."""
    if calib_path.endswith((".sfm", ".json")) and os.path.exists(calib_path):
        with open(calib_path) as f:
            head = f.read(512)
        if '"K"' in head or "'K'" in head:
            with open(calib_path) as f:
                data = json.load(f)
            K = np.asarray(data["K"], float)
            dist = np.asarray(data.get("dist", []), float)
            for i in range(dst.n_intrinsics):
                w, h = dst.sizes[i]
                dst.scale[i] = [K[0, 0], K[1, 1]]
                dst.offset[i] = [K[0, 2] - 0.5 * w, K[1, 2] - 0.5 * h]
                d = np.zeros(cam.DISTO_PARAMS)
                d[: min(len(dist), cam.DISTO_PARAMS)] = dist[: cam.DISTO_PARAMS]
                dst.disto[i] = d
                if len(dist):
                    dst.disto_kind[i] = (
                        cam.DISTO_BROWN if len(dist) > 3 else cam.DISTO_RADIALK3
                    )
            return dst.n_intrinsics
    from .. import sfmdata as sio

    src = sio.load(calib_path)
    n = 0
    for i in range(min(dst.n_intrinsics, src.n_intrinsics)):
        dst.cam_kind[i] = src.cam_kind[i]
        dst.disto_kind[i] = src.disto_kind[i]
        dst.scale[i] = src.scale[i]
        dst.offset[i] = src.offset[i]
        dst.disto[i] = src.disto[i]
        # carry the Undistortion family too (3DE lens grids — ref:
        # main_applyCalibration.cpp copies the undistortion object)
        ud = src.intrinsic_extra[i].get("undistortion")
        if ud:
            dst.intrinsic_extra[i]["undistortion"] = dict(ud)
        n += 1
    return n


def compare_scenes(scene: SfMData, ref: SfMData) -> dict:
    """Numeric regression report between two reconstructions of the same
    views (ref: main_sfmRegression.cpp). Poses are matched by view id; no
    alignment is applied — use sfmAlignment first if frames differ."""
    index = {int(ref.view_ids[v]): v for v in ref.valid_views()}
    rot_err, cen_err = [], []
    for v in scene.valid_views():
        r = index.get(int(scene.view_ids[v]))
        if r is None:
            continue
        p, q = int(scene.view_pose[v]), int(ref.view_pose[r])
        dR = scene.pose_R[p] @ ref.pose_R[q].T
        ang = np.degrees(
            np.arccos(np.clip((np.trace(dR) - 1.0) * 0.5, -1.0, 1.0))
        )
        rot_err.append(ang)
        cen_err.append(np.linalg.norm(scene.pose_c[p] - ref.pose_c[q]))
    rot = np.asarray(rot_err) if rot_err else np.zeros(1)
    cen = np.asarray(cen_err) if cen_err else np.zeros(1)
    return {
        "common_poses": len(rot_err),
        "rotation_deg_mean": float(rot.mean()),
        "rotation_deg_max": float(rot.max()),
        "center_dist_mean": float(cen.mean()),
        "center_dist_max": float(cen.max()),
        "n_landmarks": int(scene.n_landmarks),
        "n_landmarks_ref": int(ref.n_landmarks),
    }


def landmark_distances(scene: SfMData, ids_a, ids_b) -> list:
    """Distances between pairs of landmarks given by external ids
    (ref: main_sfmDistances.cpp — measure distances between markers)."""
    table = {int(i): k for k, i in enumerate(scene.landmark_ids)}
    out = []
    for a, b in zip(ids_a, ids_b):
        ia, ib = table.get(int(a)), table.get(int(b))
        if ia is None or ib is None:
            out.append(None)
        else:
            out.append(float(np.linalg.norm(scene.points[ia] - scene.points[ib])))
    return out
