"""Reference-compatible .sfm/.json scene IO (host copy of
`alicevision_tpu/sfmdata/io.py`'s JSON reader and writer).

Reads and writes the AliceVision JSON scene schema
(ref: src/aliceVision/sfmDataIO/jsonIO.cpp — views :24-49, intrinsics
:152-261, poses via savePose3 jsonIO.hpp:70-80, structure :492-532).
Values are serialized as strings (boost::ptree convention), rotations as
column-major 9-vectors, focal length in millimetres with the sensor-width
conversion of camera/IntrinsicScaleOffset.cpp. A file either package writes
loads in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .. import camera as cam
from .scene import INVALID, SfMData

_VERSION = ["1", "2", "11"]

# Reference serialization names: modern scheme is type + distortionType;
# legacy single-string names are accepted on load
# (ref: sfmDataIO/jsonIO.cpp:251-261 compatibilityStringToEnums).
_DISTO_TO_NAME = {
    cam.DISTO_NONE: "none",
    cam.DISTO_RADIALK1: "radialk1",
    cam.DISTO_RADIALK3: "radialk3",
    cam.DISTO_BROWN: "brown",
    cam.DISTO_FISHEYE: "fisheye",
    cam.DISTO_FISHEYE1: "fisheye1",
}
_NAME_TO_DISTO = {v: k for k, v in _DISTO_TO_NAME.items()}
_LEGACY = {
    # legacy "type" -> (cam_kind, disto_kind)
    "pinhole": (cam.CAM_PINHOLE, cam.DISTO_NONE),
    "radial1": (cam.CAM_PINHOLE, cam.DISTO_RADIALK1),
    "radial3": (cam.CAM_PINHOLE, cam.DISTO_RADIALK3),
    "brown": (cam.CAM_PINHOLE, cam.DISTO_BROWN),
    "fisheye": (cam.CAM_PINHOLE, cam.DISTO_FISHEYE),
    "fisheye4": (cam.CAM_PINHOLE, cam.DISTO_FISHEYE),
    "fisheye1": (cam.CAM_PINHOLE, cam.DISTO_FISHEYE1),
    "equidistant": (cam.CAM_EQUIDISTANT, cam.DISTO_NONE),
    "equidistant_r3": (cam.CAM_EQUIDISTANT, cam.DISTO_RADIALK3),
}

_N_DISTO_PARAMS = {
    cam.DISTO_NONE: 0,
    cam.DISTO_RADIALK1: 1,
    cam.DISTO_RADIALK3: 3,
    cam.DISTO_BROWN: 5,
    cam.DISTO_FISHEYE: 4,
    cam.DISTO_FISHEYE1: 1,
}


def _s(x):
    """Serialize a scalar the way boost::ptree does (everything a string)."""
    if isinstance(x, (bool, np.bool_)):
        return "true" if x else "false"
    if isinstance(x, (int, np.integer)):
        return str(int(x))
    if isinstance(x, (float, np.floating)):
        return repr(float(x))
    return str(x)


def _vec(a):
    return [_s(float(v)) for v in np.asarray(a).ravel()]


def save_sfm(scene: SfMData, path: str, save_structure: bool = True) -> None:
    views = []
    for i in range(scene.n_views):
        vid = int(scene.view_ids[i])
        posed = scene.view_pose[i] != INVALID
        v = {
            "viewId": _s(vid),
            "poseId": _s(int(scene.pose_ids[scene.view_pose[i]]) if posed else vid),
            "frameId": _s(int(scene.view_frames[i])),
            "intrinsicId": _s(int(scene.intrinsic_ids[scene.view_intrinsic[i]]))
            if scene.view_intrinsic[i] != INVALID
            else _s(0),
            "path": scene.view_paths[i],
            "width": _s(int(scene.view_sizes[i, 0])),
            "height": _s(int(scene.view_sizes[i, 1])),
        }
        if scene.view_metadata[i]:
            v["metadata"] = {k: _s(val) for k, val in scene.view_metadata[i].items()}
        views.append(v)

    intrinsics = []
    for i in range(scene.n_intrinsics):
        w, h = int(scene.sizes[i, 0]), int(scene.sizes[i, 1])
        sw, sh = float(scene.sensor_size[i, 0]), float(scene.sensor_size[i, 1])
        fx, fy = float(scene.scale[i, 0]), float(scene.scale[i, 1])
        # pixelRatio holds the pixel ASPECT ratio fy/fx
        # (ref: camera/IntrinsicScaleOffset.cpp:204-213 getPixelAspectRatio)
        par = fy / fx if fx != 0 else 1.0
        # focal mm ignoring the x-stretch (IntrinsicScaleOffset.cpp non-compat)
        focal_mm = fy * sw / w
        dk = int(scene.disto_kind[i])
        nd = _N_DISTO_PARAMS[dk]
        it = {
            "intrinsicId": _s(int(scene.intrinsic_ids[i])),
            "width": _s(w),
            "height": _s(h),
            "sensorWidth": _s(sw),
            "sensorHeight": _s(sh),
            "serialNumber": scene.intrinsic_extra[i].get("serialNumber", ""),
            "type": cam.CAM_NAMES[int(scene.cam_kind[i])],
            "initializationMode": "unknown",
            "initialFocalLength": _s(-1.0),
            "focalLength": _s(focal_mm),
            "pixelRatio": _s(par),
            "pixelRatioLocked": "false",
            "principalPoint": _vec(scene.offset[i]),
            "distortionType": _DISTO_TO_NAME[dk],
            "distortionInitializationMode": "none",
            "distortionParams": _vec(scene.disto[i, :nd]),
            "undistortionType": "none",
            "undistortionOffset": _vec([0.0, 0.0]),
            "undistortionParams": "",
            "locked": "false",
        }
        # Undistortion family (3DE lens grids) round-trip
        # (ref: sfmDataIO/jsonIO.cpp:204-222).
        ud = scene.intrinsic_extra[i].get("undistortion")
        if ud and ud.get("type", "none") != "none":
            it["undistortionType"] = ud["type"]
            it["undistortionOffset"] = _vec(ud.get("offset", [0.0, 0.0]))
            it["undistortionParams"] = [_s(float(x)) for x in ud.get("params", [])]
            it["undistortionDiagonal"] = _s(float(ud.get("diagonal", 0.0)))
            it["pixelAspectRatio"] = _s(float(ud.get("pixelAspectRatio", 1.0)))
            it["isDesqueezed"] = _s(bool(ud.get("isDesqueezed", False)))
        intrinsics.append(it)

    poses = []
    for p in range(scene.n_poses):
        poses.append(
            {
                "poseId": _s(int(scene.pose_ids[p])),
                "pose": {
                    "transform": {
                        # column-major, matching Eigen's default storage
                        "rotation": _vec(scene.pose_R[p].T),
                        "center": _vec(scene.pose_c[p]),
                    },
                    "locked": _s(bool(scene.pose_locked[p])),
                },
            }
        )

    out = {"version": _VERSION, "views": views, "intrinsics": intrinsics, "poses": poses}

    if save_structure and scene.n_landmarks:
        order = np.argsort(scene.obs_landmark, kind="stable")
        bounds = np.searchsorted(
            scene.obs_landmark[order], np.arange(scene.n_landmarks + 1)
        )
        structure = []
        for l in range(scene.n_landmarks):  # noqa: E741
            obs_entries = [
                {
                    "observationId": _s(int(scene.view_ids[scene.obs_view[o]])),
                    "featureId": _s(int(scene.obs_feature[o])),
                    "x": _vec(scene.obs_uv[o]),
                    "scale": _s(float(scene.obs_scale[o])),
                }
                for o in order[bounds[l] : bounds[l + 1]]
            ]
            structure.append(
                {
                    "landmarkId": _s(int(scene.landmark_ids[l])),
                    "descType": scene.desc_types[l] if scene.desc_types else "sift",
                    "color": _vec(scene.colors[l].astype(np.int64)),
                    "X": _vec(scene.points[l]),
                    "observations": obs_entries,
                }
            )
        out["structure"] = structure

    if scene.constraints2d:
        out["constraints2d"] = [
            {
                "viewFirst": _s(int(scene.view_ids[c["view_i"]])),
                "xFirst": _vec(np.asarray(c["uv_i"], np.float64)),
                "viewSecond": _s(int(scene.view_ids[c["view_j"]])),
                "xSecond": _vec(np.asarray(c["uv_j"], np.float64)),
            }
            for c in scene.constraints2d
        ]
    if scene.rotation_priors:
        out["rotationpriors"] = [
            {
                "viewFirst": _s(int(scene.view_ids[p["view_i"]])),
                "viewSecond": _s(int(scene.view_ids[p["view_j"]])),
                "secondRfirst": [
                    _vec(row) for row in np.asarray(p["R_j_i"], np.float64)
                ],
            }
            for p in scene.rotation_priors
        ]

    # write-then-rename: a stage killed mid-write never leaves a truncated
    # scene file behind
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(out, f, indent=1)
    os.replace(tmp, path)


def load_sfm(path: str) -> SfMData:
    with open(path) as f:
        data = json.load(f)

    scene = SfMData.empty()

    # file format version gates the focal/principal-point semantics
    # (ref: sfmDataIO/jsonIO.cpp:246-370 loadIntrinsic)
    ver = tuple(int(x) for x in data.get("version", ["1", "2", "11"]))

    id2idx_intr: dict[int, int] = {}
    for it in data.get("intrinsics", []):
        iid = int(it["intrinsicId"])
        w, h = int(it["width"]), int(it["height"])
        sw = float(it.get("sensorWidth", 36.0))
        sh = float(it.get("sensorHeight", 24.0))
        focal_mm = float(it.get("focalLength", -1.0))
        par = float(it.get("pixelRatio", 1.0))
        if "distortionType" in it:
            ck = cam.CAM_CODES.get(it.get("type", "pinhole"), cam.CAM_PINHOLE)
            dk = _NAME_TO_DISTO.get(it["distortionType"], cam.DISTO_NONE)
        else:
            ck, dk = _LEGACY.get(it.get("type", "pinhole"), (cam.CAM_PINHOLE, cam.DISTO_NONE))
        mm2px = w / sw
        if ver < (1, 2, 0):
            fx = fy = float(it.get("pxFocalLength", -1.0))
        elif ver < (1, 2, 2):
            pxf = it.get("pxFocalLength", [-1.0, -1.0])
            if not isinstance(pxf, (list, tuple)):
                pxf = [pxf, pxf]
            fx, fy = float(pxf[0]), float(pxf[1])
        elif ver < (1, 2, 5):
            # "pixelRatio" stored the focal ratio: fy = fx / focalRatio
            fx = focal_mm * mm2px
            fy = fx / par if par != 0 else fx
        elif ver < (1, 2, 11):
            # focal is X; pixel ratio stretches Y
            fx = focal_mm * mm2px
            fy = fx * par
        elif focal_mm > 0:
            # focal ignores the X stretch: fy = f, fx = f / pixelRatio
            fy = focal_mm * mm2px
            fx = (focal_mm / par) * mm2px if par != 0 else fy
        else:
            fx = fy = max(w, h)  # uninitialized — same default spirit as ref
        if fx <= 0:
            fx = fy = max(w, h)
        pp = [float(x) for x in it.get("principalPoint", [0.0, 0.0])]
        if ver < (1, 2, 1):
            # principal point was stored absolute, not offset-from-center
            pp = [pp[0] - w / 2.0, pp[1] - h / 2.0]
        dparams = [float(x) for x in it.get("distortionParams", []) or []]
        idx = scene.add_intrinsic(
            iid, w, h, fx, ck, dk, tuple(dparams), tuple(pp), (sw, sh), focal_y_px=fy
        )
        scene.intrinsic_extra[idx]["serialNumber"] = it.get("serialNumber", "")
        ut = it.get("undistortionType", "none")
        if ut != "none":
            scene.intrinsic_extra[idx]["undistortion"] = {
                "type": ut,
                "params": [float(x) for x in it.get("undistortionParams", []) or []],
                "offset": [float(x) for x in it.get("undistortionOffset", [0.0, 0.0])],
                "diagonal": float(it.get("undistortionDiagonal", 0.0)),
                "pixelAspectRatio": float(it.get("pixelAspectRatio", 1.0)),
                "isDesqueezed": it.get("isDesqueezed", "false") in (True, "true", "1"),
            }
        id2idx_intr[iid] = idx

    id2idx_pose: dict[int, int] = {}
    for p in data.get("poses", []):
        pid = int(p["poseId"])
        tr = p["pose"]["transform"]
        R = np.array([float(x) for x in tr["rotation"]]).reshape(3, 3, order="F")
        c = np.array([float(x) for x in tr["center"]])
        scene.pose_ids = np.append(scene.pose_ids, pid)
        scene.pose_R = np.concatenate([scene.pose_R, R[None]], axis=0)
        scene.pose_c = np.vstack([scene.pose_c, c])
        scene.pose_locked = np.append(
            scene.pose_locked, p["pose"].get("locked", "false") == "true"
        )
        id2idx_pose[pid] = scene.n_poses - 1

    id2idx_view: dict[int, int] = {}
    for v in data.get("views", []):
        vid = int(v["viewId"])
        iidx = id2idx_intr.get(int(v.get("intrinsicId", -1)), INVALID)
        idx = scene.add_view(
            vid,
            iidx,
            int(v["width"]),
            int(v["height"]),
            v.get("path", ""),
            int(v.get("frameId", 0)),
            v.get("metadata", {}),
        )
        pid = int(v.get("poseId", -1))
        if pid in id2idx_pose:
            scene.view_pose[idx] = id2idx_pose[pid]
        id2idx_view[vid] = idx

    structure = data.get("structure", [])
    if structure:
        pts, lids, cols, dts = [], [], [], []
        o_lm, o_view, o_uv, o_scale, o_feat = [], [], [], [], []
        for l, lm in enumerate(structure):  # noqa: E741
            lids.append(int(lm["landmarkId"]))
            pts.append([float(x) for x in lm["X"]])
            cols.append([int(float(x)) for x in lm.get("color", [255, 255, 255])])
            dts.append(lm.get("descType", "unknown"))
            for ob in lm.get("observations", []) or []:
                vid = int(ob["observationId"])
                if vid not in id2idx_view:
                    continue
                o_lm.append(l)
                o_view.append(id2idx_view[vid])
                o_uv.append([float(x) for x in ob.get("x", [0.0, 0.0])])
                o_scale.append(float(ob.get("scale", 0.0)))
                o_feat.append(int(ob.get("featureId", 0)))
        scene.landmark_ids = np.array(lids, np.int64)
        scene.points = np.array(pts) if pts else np.zeros((0, 3))
        scene.colors = np.array(cols, np.uint8) if cols else np.zeros((0, 3), np.uint8)
        scene.desc_types = dts
        scene.obs_landmark = np.array(o_lm, np.int32)
        scene.obs_view = np.array(o_view, np.int32)
        scene.obs_uv = np.array(o_uv) if o_uv else np.zeros((0, 2))
        scene.obs_scale = np.array(o_scale)
        scene.obs_feature = np.array(o_feat, np.int64)

    for c in data.get("constraints2d", []) or []:
        scene.constraints2d.append(
            {
                "view_i": id2idx_view[int(c["viewFirst"])],
                "uv_i": np.array([float(x) for x in c["xFirst"]]),
                "view_j": id2idx_view[int(c["viewSecond"])],
                "uv_j": np.array([float(x) for x in c["xSecond"]]),
            }
        )
    for p in data.get("rotationpriors", []) or []:
        scene.rotation_priors.append(
            {
                "view_i": id2idx_view[int(p["viewFirst"])],
                "view_j": id2idx_view[int(p["viewSecond"])],
                "R_j_i": np.array(
                    [[float(x) for x in row] for row in p["secondRfirst"]]
                ),
            }
        )

    return scene


_LATER = {
    ".abc": "Alembic scenes (sfmdata/alembic.py) are ported in a later slice "
    "(ROADMAP queue 1, auxiliary IO)",
    ".ply": "PLY structure export is ported with sfmdata/export.py in a later "
    "slice (ROADMAP queue 1, auxiliary IO)",
    ".baf": "BAF export is ported with sfmdata/export.py in a later slice "
    "(ROADMAP queue 1, auxiliary IO)",
}


def load(path: str) -> SfMData:
    """Extension dispatch (ref: sfmDataIO/sfmDataIO.cpp:114-170)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".sfm", ".json"):
        return load_sfm(path)
    if ext in _LATER:
        raise NotImplementedError(_LATER[ext])
    raise ValueError(f"unsupported scene format: {ext}")


def save(scene: SfMData, path: str) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".sfm", ".json"):
        save_sfm(scene, path)
    elif ext in _LATER:
        raise NotImplementedError(_LATER[ext])
    else:
        raise ValueError(f"unsupported scene format: {ext}")
