"""The dense stages of the pipeline, with their file contracts.

Port of the MVS half of `alicevision_tpu/pipeline/stages.py` (ref:
main_prepareDenseScene.cpp:71-82, main_depthMapEstimation.cpp,
main_depthMapFiltering.cpp:142-144, main_meshing.cpp:400-401). Each stage
reads and writes files, so runs resume at stage granularity:
  dense images: <viewId>.npy
  depth:        <viewId>_depth.npy / _sim.npy
  cloud:        ASCII PLY
Every stage runs its tensor work on `device` ("cuda" by default; it raises
when no CUDA device exists unless the caller passes "cpu").
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from .. import camera as cam
from .. import sfmdata
from ..device import resolve_device
from ..image.filtering import bilinear_sample
from ..image.io import read_image, write_image


def _ensure_dir(d):
    os.makedirs(d, exist_ok=True)
    return d


def _K(sc, ii: int, downscale: int, dtype=np.float32) -> np.ndarray:
    """Pinhole matrix of intrinsic ii at the processing scale."""
    fx, fy = sc.scale[ii] / downscale
    pp = (sc.offset[ii] + 0.5 * sc.sizes[ii]) / downscale
    return np.array([[fx, 0, pp[0]], [0, fy, pp[1]], [0, 0, 1.0]], dtype)


# ---------------------------------------------------------------------------
# prepareDenseScene (undistort)
# ---------------------------------------------------------------------------


def prepare_dense_scene(input_sfm: str, output_folder: str, device="cuda") -> None:
    """Undistorted grayscale images for MVS (main_prepareDenseScene.cpp)."""
    dev = resolve_device(device)
    sc = sfmdata.load(input_sfm)
    _ensure_dir(output_folder)
    intr = sc.intrinsics_table(device=dev)
    for v in sc.valid_views():
        out = os.path.join(output_folder, f"{int(sc.view_ids[v])}.npy")
        if os.path.exists(out) or not sc.view_paths[v]:
            continue
        img = read_image(sc.view_paths[v], grayscale=True)
        row = intr.row(int(sc.view_intrinsic[v]))
        H, W = img.shape
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        pix = torch.from_numpy(np.stack([xs, ys], -1).reshape(-1, 2)).to(dev)
        # undistorted pixel -> distorted source pixel
        p = cam.ima2cam(row, pix)
        pd = cam.add_distortion(row.disto_kind, row.disto, p)
        src = cam.cam2ima(row, pd)
        vals = bilinear_sample(torch.from_numpy(img).to(dev), src)
        write_image(out, vals.reshape(H, W).cpu().numpy())


# ---------------------------------------------------------------------------
# depthMapEstimation / Filtering / meshing(point cloud)
# ---------------------------------------------------------------------------


def depth_map_estimation(
    input_sfm: str,
    images_folder: str,
    output_folder: str,
    n_depths: int = 96,
    n_tcams: int = 4,
    downscale: int = 2,
    range_start: int = 0,
    range_size: int = -1,
    refine: bool = False,
    color_opt_iters: int = 20,
    tile_size: int = 0,
    tile_overlap: int = 64,
    device="cuda",
) -> None:
    """Per-view SGM depth maps (the untiled, unrefined branch of the
    reference stage)."""
    from ..mvs import plane_sweep as ps
    from ..mvs.depth_list import sgm_depth_list
    from ..mvs.fusion import depth_range_from_landmarks

    if refine:
        raise NotImplementedError(
            "refine=True needs mvs/refine.py and ops/guided_filter.py, ported "
            "in the refine slice (ROADMAP queue 1)"
        )
    dev = resolve_device(device)
    sc = sfmdata.load(input_sfm)
    _ensure_dir(output_folder)
    valid = sc.valid_views()
    end = len(valid) if range_size < 0 else min(len(valid), range_start + range_size)

    # camera tables
    K_all, R_all, c_all, imgs = {}, {}, {}, {}
    for v in valid:
        K_all[v] = _K(sc, int(sc.view_intrinsic[v]), downscale)
        p = int(sc.view_pose[v])
        R_all[v] = sc.pose_R[p].astype(np.float32)
        c_all[v] = sc.pose_c[p].astype(np.float32)
        path = os.path.join(images_folder, f"{int(sc.view_ids[v])}.npy")
        img = read_image(path, grayscale=True)
        if downscale > 1:
            img = img[::downscale, ::downscale]
        imgs[v] = img.astype(np.float32)
    if tile_size and any(max(imgs[v].shape) > tile_size for v in valid[range_start:end]):
        raise NotImplementedError(
            "the tiled path (tile_size smaller than the image) needs "
            "mvs/sharded.py, ported in the tiled-path slice (ROADMAP queue 1)"
        )

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    hw_all = {v: (imgs[v].shape[1], imgs[v].shape[0]) for v in valid}
    centers = np.stack([c_all[v] for v in valid])
    for k in range(range_start, end):
        rc = valid[k]
        out_d = os.path.join(output_folder, f"{int(sc.view_ids[rc])}_depth.npy")
        if os.path.exists(out_d):
            continue
        # T-cam selection: nearest posed views (MultiViewParams pair selection)
        d = np.linalg.norm(centers - c_all[rc], axis=1)
        order = [valid[i] for i in np.argsort(d) if valid[i] != rc][:n_tcams]
        # relative poses: x_t = R_rel x_ref + t_rel with
        # x_t = R_t (x_w - c_t), x_w = R_rc^T x_ref + c_rc
        R_rel = np.stack([R_all[o] @ R_all[rc].T for o in order])
        t_rel = np.stack([R_all[o] @ (c_all[rc] - c_all[o]) for o in order])

        # SfM-seeded per-view depth list + per-T-cam sub-ranges
        # (ref: src/aliceVision/depthMap/SgmDepthList.cpp:48-75,272,412)
        d_min, d_max = depth_range_from_landmarks(sc.points, R_all[rc], c_all[rc])
        dl = sgm_depth_list(
            sc.points, sc.obs_landmark, sc.obs_view, sc.obs_uv,
            rc, R_all, c_all, K_all, hw_all, order, n_depths,
            fallback_range=(d_min, d_max),
        )
        tc_ranges = np.stack(
            [dl.depths[dl.tc_limits[:, 0]],
             dl.depths[np.clip(dl.tc_limits[:, 1] - 1, 0, n_depths - 1)]],
            axis=1,
        ).astype(np.float32)
        logging.getLogger("alicevision_tpu_torch").info(
            "depthMap view %d: %d planes in [%.3f, %.3f] from %d seeds; "
            "tcam plane counts %s",
            int(sc.view_ids[rc]), len(dl.depths), dl.d_min, dl.d_max,
            dl.n_obs, (dl.tc_limits[:, 1] - dl.tc_limits[:, 0]).tolist(),
        )
        depth, sim = ps.sgm_depth_map(
            t(imgs[rc]),
            t(np.stack([imgs[o] for o in order])),
            t(K_all[rc]),
            t(np.stack([K_all[o] for o in order])),
            t(R_rel),
            t(t_rel),
            dl.d_min,
            dl.d_max,
            ps.SgmParams(n_depths=n_depths),
            depths=dl.depths,
            tc_depth_ranges=t(tc_ranges),
        )
        np.save(out_d, depth.cpu().numpy())
        np.save(
            os.path.join(output_folder, f"{int(sc.view_ids[rc])}_sim.npy"),
            sim.cpu().numpy(),
        )


def _posed_depth_maps(sc, depth_folder, downscale, dtype):
    """Depth maps present in depth_folder with their cameras."""
    depths, Ks, Rs, cs, ids = [], [], [], [], []
    for v in sc.valid_views():
        vid = int(sc.view_ids[v])
        p = os.path.join(depth_folder, f"{vid}_depth.npy")
        if not os.path.exists(p):
            continue
        depths.append(np.load(p))
        Ks.append(_K(sc, int(sc.view_intrinsic[v]), downscale, dtype))
        pi = int(sc.view_pose[v])
        Rs.append(sc.pose_R[pi].astype(dtype))
        cs.append(sc.pose_c[pi].astype(dtype))
        ids.append(vid)
    return depths, Ks, Rs, cs, ids


def depth_map_filtering(
    input_sfm: str,
    depth_folder: str,
    output_folder: str,
    min_consistent: int = 3,
    downscale: int = 2,
    compute_normal_maps: bool = False,
    n_nearest_cams: int = 0,
    device="cuda",
) -> None:
    """Cross-view consistency filtering of per-view depth maps.

    n_nearest_cams > 0 bounds each view's consistency set to its ±k ring
    neighbours in view order (fuseCut/Fuser.hpp:21-34 + maxNbNearestCams);
    0 = all-pairs."""
    from ..mvs.fusion import consistency_filter, consistency_filter_ring

    if compute_normal_maps:
        raise NotImplementedError(
            "compute_normal_maps=True needs mvs/normals.py, ported in the "
            "normals slice (ROADMAP queue 1)"
        )
    dev = resolve_device(device)
    sc = sfmdata.load(input_sfm)
    _ensure_dir(output_folder)
    depths, Ks, Rs, cs, ids = _posed_depth_maps(sc, depth_folder, downscale, np.float32)
    if not depths:
        return
    args = [
        torch.as_tensor(np.stack(a), dtype=torch.float32, device=dev)
        for a in (depths, Ks, Rs, cs)
    ]
    if n_nearest_cams > 0:
        filt, _ = consistency_filter_ring(
            *args, k=n_nearest_cams, min_consistent=min_consistent
        )
    else:
        filt, _ = consistency_filter(*args, min_consistent=min_consistent)
    filt = filt.cpu().numpy()
    for i, vid in enumerate(ids):
        np.save(os.path.join(output_folder, f"{vid}_depth.npy"), filt[i])


def meshing_point_cloud(
    input_sfm: str,
    depth_folder: str,
    output_ply: str,
    voxel_size: float = 0.0,
    downscale: int = 2,
    device="cuda",
) -> np.ndarray:
    """Fuse the depth maps into one cloud and write it as an ASCII PLY."""
    from ..mvs.fusion import fuse_point_cloud

    dev = resolve_device(device)
    sc = sfmdata.load(input_sfm)
    depths, Ks, Rs, cs, _ = _posed_depth_maps(sc, depth_folder, downscale, np.float64)
    pts, cols, _ = fuse_point_cloud(
        np.stack(depths), None, np.stack(Ks), np.stack(Rs), np.stack(cs),
        voxel_size=voxel_size, device=dev,
    )
    with open(output_ply, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(pts)}\n"
            "property double x\nproperty double y\nproperty double z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        f.writelines(
            f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n" for p, c in zip(pts, cols)
        )
    return pts
