"""Scene merging and splitting utilities.

Host copy of `alicevision_tpu/sfmdata/merge.py`, the counterpart of the reference's sfmMerge / sfmSplitReconstructed tools
(ref: src/software/utils/main_sfmMerge.cpp — concatenate two scenes with
id collision handling; main_sfmSplitReconstructed.cpp — separate
reconstructed from non-reconstructed views).
"""

from __future__ import annotations

import numpy as np

from .scene import INVALID, SfMData


def merge_scenes(a: SfMData, b: SfMData, align: bool = False) -> SfMData:
    """Concatenate scene b into a copy of a. Shared view ids keep a's entry;
    b's other ids are appended (id collisions for distinct content are
    re-keyed). With align=True, b is first similarity-aligned onto a via
    shared posed views (the reference's alignment option)."""
    import copy

    if align:
        from ..sfm.alignment import align_to_scene

        b = copy.deepcopy(b)
        align_to_scene(b, a)

    out = copy.deepcopy(a)
    a_ids = set(int(v) for v in a.view_ids)
    a_intr_ids = set(int(i) for i in a.intrinsic_ids)

    # intrinsics of b (re-key on collision with different params)
    intr_map = {}
    for i in range(b.n_intrinsics):
        bid = int(b.intrinsic_ids[i])
        new_id = bid
        while new_id in a_intr_ids:
            new_id += 100000
        a_intr_ids.add(new_id)
        idx = out.add_intrinsic(
            new_id,
            int(b.sizes[i, 0]),
            int(b.sizes[i, 1]),
            float(b.scale[i, 0]),
            cam_kind=int(b.cam_kind[i]),
            disto_kind=int(b.disto_kind[i]),
            disto_params=tuple(b.disto[i]),
            offset=tuple(b.offset[i]),
            sensor_mm=tuple(b.sensor_size[i]),
            focal_y_px=float(b.scale[i, 1]),
        )
        intr_map[i] = idx

    lm_base = int(out.landmark_ids.max()) + 1 if out.n_landmarks else 0
    view_map = {}
    for v in range(b.n_views):
        vid = int(b.view_ids[v])
        if vid in a_ids:
            view_map[v] = list(out.view_ids).index(vid)
            continue
        idx = out.add_view(
            vid,
            intr_map.get(int(b.view_intrinsic[v]), INVALID),
            int(b.view_sizes[v, 0]),
            int(b.view_sizes[v, 1]),
            path=b.view_paths[v],
            frame_id=int(b.view_frames[v]),
        )
        view_map[v] = idx
        p = int(b.view_pose[v])
        if p != INVALID:
            out.set_pose(idx, b.pose_R[p], b.pose_c[p])

    if b.n_landmarks:
        out.landmark_ids = np.concatenate(
            [out.landmark_ids, b.landmark_ids + lm_base]
        )
        out.points = np.vstack([out.points, b.points])
        out.colors = np.vstack([out.colors, b.colors])
        out.desc_types = list(out.desc_types) + list(b.desc_types)
        keep = np.array([view_map.get(int(v), -1) for v in b.obs_view])
        ok = keep >= 0
        out.obs_landmark = np.concatenate(
            [out.obs_landmark, (b.obs_landmark + len(out.points) - len(b.points))[ok]]
        ).astype(np.int32)
        out.obs_view = np.concatenate([out.obs_view, keep[ok]]).astype(np.int32)
        out.obs_uv = np.vstack([out.obs_uv, b.obs_uv[ok]])
        out.obs_scale = np.concatenate([out.obs_scale, b.obs_scale[ok]])
        out.obs_feature = np.concatenate([out.obs_feature, b.obs_feature[ok]])
    return out


def split_reconstructed(scene: SfMData):
    """(reconstructed, non_reconstructed) view partitions as new scenes."""
    import copy

    posed = scene.view_pose != INVALID

    def subset(mask):
        out = copy.deepcopy(scene)
        keep = np.nonzero(mask)[0]
        remap = -np.ones(scene.n_views, np.int64)
        remap[keep] = np.arange(len(keep))
        out.view_ids = scene.view_ids[keep]
        out.view_intrinsic = scene.view_intrinsic[keep]
        out.view_pose = scene.view_pose[keep]
        out.view_sizes = scene.view_sizes[keep]
        out.view_paths = [scene.view_paths[i] for i in keep]
        out.view_frames = scene.view_frames[keep]
        out.view_metadata = [scene.view_metadata[i] for i in keep]
        ok = mask[scene.obs_view]
        out.obs_landmark = scene.obs_landmark[ok]
        out.obs_view = remap[scene.obs_view[ok]].astype(np.int32)
        out.obs_uv = scene.obs_uv[ok]
        out.obs_scale = scene.obs_scale[ok]
        out.obs_feature = scene.obs_feature[ok]
        return out

    rec = subset(posed)
    non = subset(~posed)
    # the non-reconstructed part carries no structure
    non.landmark_ids = np.zeros(0, np.int64)
    non.points = np.zeros((0, 3))
    non.colors = np.zeros((0, 3), np.uint8)
    non.desc_types = []
    non.obs_landmark = np.zeros(0, np.int32)
    non.obs_view = np.zeros(0, np.int32)
    non.obs_uv = np.zeros((0, 2))
    non.obs_scale = np.zeros(0)
    non.obs_feature = np.zeros(0, np.int64)
    non.pose_ids = np.zeros(0, np.int64)
    non.pose_R = np.zeros((0, 3, 3))
    non.pose_c = np.zeros((0, 3))
    non.pose_locked = np.zeros(0, bool)
    non.view_pose[:] = INVALID
    return rec, non
