"""Scene alignment / similarity transforms.

A host copy of `alicevision_tpu/sfm/alignment.py`, the counterpart of
the reference's alignment utilities
(ref: src/aliceVision/sfm/utils/alignment.cpp — sfmTransform modes:
auto-centering, alignment to another reconstruction via common poses,
scaling; geometry/rigidTransformation3D.cpp Umeyama estimation). Used by
the sfmTransform/sfmAlignment CLI stages and the ATE evaluation in tests.
"""

from __future__ import annotations

import numpy as np

from ..sfmdata import INVALID, SfMData


def umeyama_similarity(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity s, R, t with dst ~ s R src + t."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    H = dc.T @ sc / len(src)
    U, S, Vt = np.linalg.svd(H)
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    if with_scale:
        var = (sc**2).sum() / len(src)
        s = float(np.trace(np.diag(S) @ D) / var)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def transform_scene(scene: SfMData, s: float, R: np.ndarray, t: np.ndarray) -> None:
    """Apply x -> s R x + t to all poses and landmarks in place.

    Camera rotation transforms as R_cam R^T; centers as points.
    """
    scene.points = scene.points @ (s * R).T + t
    scene.pose_c = scene.pose_c @ (s * R).T + t
    scene.pose_R = np.einsum("vij,kj->vik", scene.pose_R, R)


def align_to_scene(scene: SfMData, ref: SfMData, with_scale: bool = True):
    """Align `scene` onto `ref` using poses of shared view ids
    (sfmTransform --method from_poses)."""
    ids_a = {int(v): i for i, v in enumerate(scene.view_ids)}
    src, dst = [], []
    for i, vid in enumerate(ref.view_ids):
        vid = int(vid)
        if vid in ids_a:
            pa = scene.view_pose[ids_a[vid]]
            pb = ref.view_pose[i]
            if pa != INVALID and pb != INVALID:
                src.append(scene.pose_c[pa])
                dst.append(ref.pose_c[pb])
    if len(src) < 3:
        raise ValueError("need >= 3 shared posed views to align")
    s, R, t = umeyama_similarity(np.array(src), np.array(dst), with_scale)
    transform_scene(scene, s, R, t)
    return s, R, t


def auto_center_scale(scene: SfMData, target_extent: float = 1.0):
    """Center on the pose centroid, scale the pose bounding sphere to
    target_extent (sfmTransform --method auto)."""
    if scene.n_poses == 0:
        return 1.0, np.eye(3), np.zeros(3)
    centroid = scene.pose_c.mean(0)
    radius = np.linalg.norm(scene.pose_c - centroid, axis=-1).max()
    s = target_extent / max(radius, 1e-12)
    R = np.eye(3)
    t = -s * centroid
    transform_scene(scene, s, R, t)
    return s, R, t


def ate_rmse(scene: SfMData, ref: SfMData, align: bool = True) -> float:
    """Absolute trajectory error (RMSE of camera centers, after optional
    similarity alignment) — the qualityEvaluation metric
    (ref: src/software/utils/main_qualityEvaluation.cpp)."""
    ids_a = {int(v): i for i, v in enumerate(scene.view_ids)}
    src, dst = [], []
    for i, vid in enumerate(ref.view_ids):
        vid = int(vid)
        if vid in ids_a:
            pa = scene.view_pose[ids_a[vid]]
            pb = ref.view_pose[i]
            if pa != INVALID and pb != INVALID:
                src.append(scene.pose_c[pa])
                dst.append(ref.pose_c[pb])
    src, dst = np.array(src), np.array(dst)
    if align:
        s, R, t = umeyama_similarity(src, dst)
        src = src @ (s * R).T + t
    return float(np.sqrt(np.mean(np.sum((src - dst) ** 2, axis=1))))


def robust_similarity(
    src: np.ndarray,
    dst: np.ndarray,
    n_iters: int = 256,
    inlier_frac_thresh: float = 0.05,
    seed: int = 0,
):
    """RANSAC similarity dst ~ s R src + t from 3-point Umeyama samples,
    refit on the inlier set (the ACRansac_FindRTS pattern,
    ref: src/aliceVision/geometry/rigidTransformation3D.cpp). The inlier
    threshold adapts to the destination cloud extent."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n = len(src)
    if n < 3:
        raise ValueError("need >= 3 correspondences")
    rng = np.random.RandomState(seed)
    extent = np.linalg.norm(dst - dst.mean(0), axis=1).mean()
    thresh = max(inlier_frac_thresh * extent, 1e-12)
    best_inl = None
    best_cnt = -1
    for _ in range(min(n_iters, 4 * n * n + 8)):
        idx = rng.choice(n, 3, replace=False)
        try:
            s, R, t = umeyama_similarity(src[idx], dst[idx])
        except np.linalg.LinAlgError:
            continue
        if not np.isfinite(s) or s <= 0:
            continue
        err = np.linalg.norm(src @ (s * R).T + t - dst, axis=1)
        inl = err < thresh
        if inl.sum() > best_cnt:
            best_cnt = int(inl.sum())
            best_inl = inl
    if best_inl is None or best_cnt < 3:
        return umeyama_similarity(src, dst)
    s, R, t = umeyama_similarity(src[best_inl], dst[best_inl])
    return s, R, t


def align_from_gps(scene: SfMData, llh_by_view: dict):
    """Transform the scene into the ECEF frame of per-view GPS tags
    (sfmTransform --method from_gps; ref: sfm/utils/alignment.cpp:1157
    computeNewCoordinateSystemFromGpsData — robust similarity between
    posed camera centers and WGS84->cartesian GPS positions).

    llh_by_view: {view_id: (lat_deg, lon_deg, alt_m)}. Needs >= 4 tagged
    posed views (the reference's minimum)."""
    from ..geometry.gps import wgs84_to_cartesian

    src, dst = [], []
    for i, vid in enumerate(scene.view_ids):
        vid = int(vid)
        p = scene.view_pose[i]
        if vid in llh_by_view and p != INVALID:
            src.append(scene.pose_c[p])
            dst.append(wgs84_to_cartesian(llh_by_view[vid]))
    if len(src) < 4:
        raise ValueError("not enough GPS-tagged posed views (need >= 4)")
    s, R, t = robust_similarity(np.array(src), np.array(dst))
    transform_scene(scene, s, R, t)
    return s, R, t


def align_from_markers(scene: SfMData, markers: dict, desc_prefix=("tag", "cctag")):
    """Align on marker landmarks with known world coordinates
    (sfmTransform --method from_markers; ref: sfm/utils/alignment.cpp
    computeNewCoordinateSystemFromSpecificMarkers — a marker landmark's
    feature id IS the marker id).

    markers: {marker_id: (x, y, z) target coordinates}."""
    src, dst = [], []
    for li in range(len(scene.points)):
        dt = scene.desc_types[li] if li < len(scene.desc_types) else "sift"
        if not str(dt).startswith(tuple(desc_prefix)):
            continue
        sel = np.nonzero(scene.obs_landmark == li)[0]
        if len(sel) == 0:
            continue
        mid = int(scene.obs_feature[sel[0]])
        if mid in markers:
            src.append(scene.points[li])
            dst.append(np.asarray(markers[mid], np.float64))
    if len(src) < 3:
        raise ValueError("not enough matched markers (need >= 3)")
    s, R, t = robust_similarity(np.array(src), np.array(dst))
    transform_scene(scene, s, R, t)
    return s, R, t
