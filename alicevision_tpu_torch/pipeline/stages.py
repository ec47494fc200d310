"""The stages of the pipeline's main path, with their file contracts.

Port of the stages of `alicevision_tpu/pipeline/stages.py` on the main path
(ref: main_cameraInit.cpp:323-343, main_featureExtraction.cpp,
main_imageMatching.cpp:209, main_featureMatching.cpp, main_incrementalSfM.cpp,
main_tracksBuilding.cpp, main_prepareDenseScene.cpp:71-82,
main_depthMapEstimation.cpp, main_depthMapFiltering.cpp:142-144,
main_meshing.cpp:400-401). Each stage reads and writes files, so runs
resume at stage granularity; the files are the reference package's, so
either package reads the other's:
  scene:        .sfm JSON
  features:     <viewId>.feat.npz (xy, scale, orientation, response,
                desc as uint8, valid)
  pairs:        pairs.txt ("i j" per line, view indices)
  matches:      matches.npz (one (K, 2) array of feature ids per "i_j")
  tracks:       tracks.npz (track_ids, views, features, n_tracks)
  dense images: <viewId>.npy
  depth:        <viewId>_depth.npy / _sim.npy
  cloud:        ASCII PLY
Every stage takes `device` ("cuda" by default; it raises when no CUDA
device exists unless the caller passes "cpu") and computes its tensors
there; cameraInit reads files and EXIF only, on the host.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from .. import camera as cam
from .. import sfmdata
from ..device import resolve_device
from ..image.filtering import _resize_bilinear, bilinear_sample
from ..image.io import read_exif, read_image, write_image
from ..utils import sensor_db as sdb


def _ensure_dir(d):
    os.makedirs(d, exist_ok=True)
    return d


def _K(sc, ii: int, downscale: int, dtype=np.float32) -> np.ndarray:
    """Pinhole matrix of intrinsic ii at the processing scale."""
    fx, fy = sc.scale[ii] / downscale
    pp = (sc.offset[ii] + 0.5 * sc.sizes[ii]) / downscale
    return np.array([[fx, 0, pp[0]], [0, fy, pp[1]], [0, 0, 1.0]], dtype)


# ---------------------------------------------------------------------------
# cameraInit
# ---------------------------------------------------------------------------


def camera_init(
    image_folder: str,
    output_sfm: str,
    sensor_db_path: str | None = None,
    default_focal_px: float | None = None,
    device="cuda",
) -> sfmdata.SfMData:
    """Scan a folder of images -> .sfm with views + EXIF-derived intrinsics.

    Groups views by (make, model, focal, size) into shared intrinsics like
    the reference's cameraInit. It computes nothing on `device`; it takes
    it as every stage does, so that a chain run on a machine without the
    card fails at its first stage."""
    resolve_device(device)
    db = sdb.parse_database(sensor_db_path) if sensor_db_path else None
    exts = {".jpg", ".jpeg", ".png", ".tif", ".tiff", ".bmp", ".exr", ".npy"}
    files = sorted(
        f for f in os.listdir(image_folder) if os.path.splitext(f)[1].lower() in exts
    )
    if not files:
        raise FileNotFoundError(f"no images in {image_folder}")

    sc = sfmdata.SfMData.empty()
    intr_key_to_idx: dict = {}
    for i, fname in enumerate(files):
        path = os.path.join(image_folder, fname)
        meta = read_exif(path)
        if "width" not in meta:
            img = read_image(path)
            meta["height"], meta["width"] = img.shape[:2]
        w, h = int(meta["width"]), int(meta["height"])
        if default_focal_px is not None:
            focal_px, sensor_w = default_focal_px, 36.0
        else:
            focal_px, _ = sdb.focal_px_from_exif(meta, w, db)
            sensor_w, _ = sdb.sensor_width_mm(meta.get("make", ""), meta.get("model", ""), db)
        key = (meta.get("make", ""), meta.get("model", ""), round(focal_px, 1), w, h)
        if key not in intr_key_to_idx:
            intr_key_to_idx[key] = sc.add_intrinsic(
                1000 + len(intr_key_to_idx),
                w,
                h,
                focal_px,
                disto_kind=cam.DISTO_RADIALK3,
                disto_params=(0.0, 0.0, 0.0),
                sensor_mm=(sensor_w, sensor_w * h / w),
            )
        sc.add_view(i + 1, intr_key_to_idx[key], w, h, path=path, frame_id=i)
    sfmdata.save(sc, output_sfm)
    return sc


# ---------------------------------------------------------------------------
# featureExtraction
# ---------------------------------------------------------------------------

# Views a describer call takes, as the reference's vmapped batch.
_BATCH = 8

# Host syncs of the last feature_extraction call's describer batches: one
# device-to-host copy a batch (the counter chip_smoke.py reports).
extraction_host_copies = 0


def _not_ported(what: str, queue: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue {queue})")


def feature_extraction(
    input_sfm: str,
    output_folder: str,
    max_keypoints: int = 4096,
    dsp: bool = False,
    range_start: int = 0,
    range_size: int = -1,
    downscale_to: int = 1024,
    describer_types: str = "sift",
    device="cuda",
) -> None:
    """SIFT features per view -> <viewId>.feat.npz.

    describer_types is a comma list from {sift, dspsift} ("dspsift" selects
    domain-size-pooled descriptors, the reference's default describer);
    akaze, akaze_mldb, tag16h5 and cctag3 raise NotImplementedError.
    range_start/range_size mirror the reference's chunked farm runs
    (main_featureExtraction.cpp --rangeStart/--rangeSize). Images larger
    than `downscale_to` are resized (OpenCV's INTER_LINEAR, on the device)
    and the keypoints scaled back. Views of one size go through the
    describer `_BATCH` at a time, and each batch's features come back to
    the host in one copy."""
    global extraction_host_copies
    from ..features import sift

    dev = resolve_device(device)
    types = [t.strip() for t in describer_types.split(",") if t.strip()]
    for t in types:
        if t in ("akaze", "akaze_mldb"):
            _not_ported(f"describer {t!r} (features/akaze.py)", "13, front-end extras")
        if t in ("tag16h5", "cctag3"):
            _not_ported(f"marker describer {t!r} (features/markers.py)", "13, front-end extras")
    sc = sfmdata.load(input_sfm)
    _ensure_dir(output_folder)
    end = sc.n_views if range_size < 0 else min(sc.n_views, range_start + range_size)
    dsp = dsp or ("dspsift" in types)
    if not ("sift" in types or "dspsift" in types):
        return
    cfg = sift.SiftConfig(max_keypoints=max_keypoints, dsp=dsp, n_octaves=4)

    # load pending views, record per-view rescale factors
    pending, imgs, scales = [], {}, {}
    for v in range(range_start, end):
        out = os.path.join(output_folder, f"{int(sc.view_ids[v])}.feat.npz")
        if os.path.exists(out):
            continue
        img = read_image(sc.view_paths[v], grayscale=True).astype(np.float32)
        scales[v] = downscale_to / max(img.shape) if downscale_to and max(img.shape) > downscale_to else 1.0
        pending.append(v)
        imgs[v] = img

    by_shape: dict = {}
    for v in pending:
        by_shape.setdefault(imgs[v].shape, []).append(v)
    extraction_host_copies = 0
    for (H, W), vs in by_shape.items():
        scale = scales[vs[0]]
        size = (int(W * scale), int(H * scale))
        for s in range(0, len(vs), _BATCH):
            chunk = vs[s : s + _BATCH]
            stack = torch.from_numpy(np.stack([imgs[v] for v in chunk])).to(dev)
            if scale != 1.0:
                stack = _resize_bilinear(stack, size)
            f = sift.extract(stack, cfg)
            meta = torch.stack(
                [f.xy[..., 0], f.xy[..., 1], f.scale, f.orientation, f.response, f.valid.to(torch.float32)],
                dim=-1,
            )  # (B, N, 6) float32, viewed as bytes beside the uint8 descriptors
            packed = torch.cat([meta.view(torch.uint8), sift.quantize_desc(f.desc)], dim=-1).cpu().numpy()
            extraction_host_copies += 1
            meta = packed[:, :, :24].copy().view(np.float32)
            for g, v in enumerate(chunk):
                np.savez_compressed(
                    os.path.join(output_folder, f"{int(sc.view_ids[v])}.feat.npz"),
                    xy=meta[g, :, :2] / scales[v],
                    scale=meta[g, :, 2] / scales[v],
                    orientation=meta[g, :, 3],
                    response=meta[g, :, 4],
                    # uint8 on disk, as the reference's unsigned-char .desc;
                    # load_features dequantizes
                    desc=packed[g, :, 24:],
                    valid=meta[g, :, 5] > 0.5,
                )


def load_features(features_folder: str, view_id: int) -> dict:
    with np.load(os.path.join(features_folder, f"{view_id}.feat.npz")) as z:
        out = {k: z[k] for k in z.files}
    if out["desc"].dtype == np.uint8:  # quantized SIFT descriptors
        out["desc"] = out["desc"].astype(np.float32) / 512.0
    return out


# ---------------------------------------------------------------------------
# imageMatching (pair selection)
# ---------------------------------------------------------------------------


def image_matching(
    input_sfm: str,
    features_folder: str,
    output_pairs: str,
    method: str = "exhaustive",  # exhaustive | voctree | sequential
    n_neighbors: int = 10,
    tree_branching: int = 8,
    tree_levels: int = 3,
    device="cuda",
) -> np.ndarray:
    """Candidate image pairs -> pairs.txt. The vocabulary tree is trained
    on the views' own descriptors with a generator seeded 0 on `device`."""
    from ..matching import voctree as vt

    dev = resolve_device(device)
    sc = sfmdata.load(input_sfm)
    n = sc.n_views
    if method == "exhaustive" or n <= 2:
        pairs = vt.exhaustive_pairs(n)
    elif method == "sequential":
        pairs = vt.sequential_pairs(n, window=n_neighbors)
    elif method == "frustum":
        _not_ported("method='frustum' (sfm/frustum.py)", "13, the rest of SfM")
    elif method == "voctree":
        descs, valids = [], []
        for v in range(n):
            f = load_features(features_folder, int(sc.view_ids[v]))
            descs.append(torch.from_numpy(f["desc"]).to(dev))
            valids.append(torch.from_numpy(f["valid"]).to(dev))
        train = torch.cat(descs)[torch.cat(valids)]
        gen = torch.Generator(device=dev).manual_seed(0)
        tree = vt.build_voctree(gen, train, n_children=tree_branching, n_levels=tree_levels)
        bows = torch.stack([vt.bow_vector(tree, d, m) for d, m in zip(descs, valids)])
        pairs = vt.query_pairs(vt.build_database(tree, bows), n_neighbors=n_neighbors)
    else:
        raise ValueError(method)
    with open(output_pairs, "w") as f:
        for i, j in pairs:
            f.write(f"{i} {j}\n")
    return pairs


def load_pairs(path: str) -> np.ndarray:
    out = []
    with open(path) as f:
        for line in f:
            a, b = line.split()
            out.append((int(a), int(b)))
    return np.array(out, np.int64).reshape(-1, 2)


# ---------------------------------------------------------------------------
# featureMatching (photometric + geometric filter)
# ---------------------------------------------------------------------------


def feature_matching(
    input_sfm: str,
    features_folder: str,
    pairs_file: str,
    output_matches: str,
    ratio: float = 0.8,
    geometric: str = "fundamental",  # fundamental | essential | homography_growing | none
    n_ransac_hyps: int = 256,
    max_error_px: float = 4.0,
    range_start: int = 0,
    range_size: int = -1,
    device="cuda",
) -> None:
    """Top-2 ratio matching of every pair, then AC-RANSAC F filtering
    ("essential" takes the F filter too, as in the reference package;
    "none" keeps the photometric matches) -> matches.npz.

    Pairs go through the matcher `_BATCH` at a time as one batched top-2
    product over the stacked (V, N, 128) descriptor table, and through
    AC-RANSAC `_BATCH` at a time, padded to the chunk's largest match count;
    each chunk comes back to the host in one copy. The RANSAC samples come
    from a generator seeded 0 on `device`."""
    from .. import robust
    from ..matching import descriptor_matching as dm

    if geometric == "homography_growing":
        _not_ported("geometric='homography_growing' (matching/hgrowing.py)", "13, front-end extras")
    dev = resolve_device(device)
    sc = sfmdata.load(input_sfm)
    pairs = load_pairs(pairs_file)
    end = len(pairs) if range_size < 0 else min(len(pairs), range_start + range_size)
    pairs = [(int(pairs[p, 0]), int(pairs[p, 1])) for p in range(range_start, end)]

    feats = {}

    def get(v):
        if v not in feats:
            feats[v] = load_features(features_folder, int(sc.view_ids[v]))
        return feats[v]

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out: dict[str, np.ndarray] = {}

    # --- photometric pass, _BATCH pairs a call ---------------------------
    need = sorted({v for p in pairs for v in p})
    cap_sets: dict = {}
    for v in need:
        cap_sets.setdefault(get(v)["desc"].shape, []).append(v)
    pm_all: dict = {}
    if len(cap_sets) == 1 and len(pairs) > 1:
        desc_d = tensor(np.stack([get(v)["desc"] for v in need]))
        valid_d = tensor(np.stack([get(v)["valid"] for v in need]))
        row = {v: r for r, v in enumerate(need)}
        for s in range(0, len(pairs), _BATCH):
            chunk = pairs[s : s + _BATCH]
            ii = tensor(np.array([row[p[0]] for p in chunk], np.int64))
            jj = tensor(np.array([row[p[1]] for p in chunk], np.int64))
            idx2 = dm.match_bruteforce(
                desc_d[ii], desc_d[jj], valid_d[ii], valid_d[jj], ratio=ratio
            ).idx2.cpu().numpy()
            for g, (i, j) in enumerate(chunk):
                rows = np.nonzero(idx2[g] >= 0)[0]
                pm_all[(i, j)] = np.stack([rows, idx2[g][rows]], axis=-1)
    else:  # mixed feature capacities: one pair a call
        for i, j in pairs:
            fi, fj = get(i), get(j)
            m = dm.match_bruteforce(
                tensor(fi["desc"]), tensor(fj["desc"]), tensor(fi["valid"]), tensor(fj["valid"]),
                ratio=ratio,
            )
            pm_all[(i, j)] = dm.matches_to_pairs(m)

    # --- geometric pass, bucketed by image size ---------------------------
    todo_geo: dict = {}
    for i, j in pairs:
        pm = pm_all[(i, j)]
        if len(pm) < 8 or geometric == "none":
            out[f"{i}_{j}"] = pm
            continue
        w, h = float(sc.view_sizes[i, 0]), float(sc.view_sizes[i, 1])
        todo_geo.setdefault((w, h), []).append((i, j, pm))

    gen = torch.Generator(device=dev).manual_seed(0)
    for (w, h), items in todo_geo.items():
        for s in range(0, len(items), _BATCH):
            chunk = items[s : s + _BATCH]
            cap = max(len(pm) for _, _, pm in chunk)
            x1 = np.zeros((len(chunk), cap, 2), np.float32)
            x2 = np.zeros((len(chunk), cap, 2), np.float32)
            vmask = np.zeros((len(chunk), cap), bool)
            for g, (i, j, pm) in enumerate(chunk):
                n = len(pm)
                x1[g, :n] = get(i)["xy"][pm[:, 0]]
                x2[g, :n] = get(j)["xy"][pm[:, 1]]
                vmask[g, :n] = True
            rm = robust.robust_fundamental_batch(
                gen, tensor(x1), tensor(x2), (w, h), tensor(vmask),
                n_hyps=n_ransac_hyps, max_error_px=max_error_px,
            )
            inl_b = rm.inliers.cpu().numpy()
            for g, (i, j, pm) in enumerate(chunk):
                out[f"{i}_{j}"] = pm[inl_b[g, : len(pm)]]
    np.savez_compressed(output_matches, **out)


def load_matches(path: str) -> dict:
    out = {}
    with np.load(path) as z:
        for k in z.files:
            i, j = k.split("_")
            out[(int(i), int(j))] = z[k]
    return out


# ---------------------------------------------------------------------------
# incrementalSfm, tracksBuilding
# (ref: main_incrementalSfM.cpp, main_tracksBuilding.cpp)
# ---------------------------------------------------------------------------


def _tracks_from_files(sc, features_folder, matches_file, min_track_length):
    from ..tracks.builder import build_tracks

    feats = {v: load_features(features_folder, int(sc.view_ids[v])) for v in range(sc.n_views)}
    tracks = build_tracks(
        load_matches(matches_file), {v: len(f["xy"]) for v, f in feats.items()},
        min_track_length=min_track_length,
    )
    return tracks, {v: f["xy"] for v, f in feats.items()}


# The engine of the last incremental_sfm call (its history, step seconds and
# result), for the callers that report on it.
last_engine = None


def incremental_sfm(
    input_sfm: str,
    features_folder: str,
    matches_file: str,
    output_sfm: str,
    min_track_length: int = 2,
    seed: int = 0,
    config=None,
    device="cuda",
):
    """Tracks from the matches, then the incremental engine -> .sfm with
    the poses, the refined intrinsics and the landmarks (landmark_ids are
    track indices). `config` (an IncrementalConfig) overrides the engine
    defaults. The engine is kept in `last_engine`."""
    global last_engine
    from ..sfm.incremental import IncrementalConfig, IncrementalSfM

    dev = resolve_device(device)
    sc = sfmdata.load(input_sfm)
    tracks, features_xy = _tracks_from_files(sc, features_folder, matches_file, min_track_length)
    engine = IncrementalSfM(
        tracks,
        features_xy,
        sc.intrinsics_table(),
        view_intrinsic=sc.view_intrinsic,
        image_sizes=sc.view_sizes,
        config=config if config is not None else IncrementalConfig(seed=seed),
        device=dev,
    )
    last_engine = engine
    engine.process()
    out = engine.to_sfmdata(view_ids=sc.view_ids)
    out.view_paths = list(sc.view_paths)
    sfmdata.save(out, output_sfm)
    return out


def tracks_building(
    input_sfm: str,
    features_folder: str,
    matches_file: str,
    output_tracks: str,
    min_track_length: int = 2,
    device="cuda",
) -> None:
    """Tracks from the matches -> tracks.npz (track_ids, views, features,
    n_tracks). The union-find runs on the host; `device` is taken as every
    stage takes it."""
    resolve_device(device)
    sc = sfmdata.load(input_sfm)
    tr, _ = _tracks_from_files(sc, features_folder, matches_file, min_track_length)
    np.savez_compressed(
        output_tracks, track_ids=tr.track_ids, views=tr.views, features=tr.features, n_tracks=np.int64(tr.n_tracks)
    )


def sfm_bootstrapping(input_sfm: str, features_folder: str, tracks_file: str, output_sfm: str, device="cuda"):
    _not_ported("sfmBootstrapping (sfm/expansion.py)", "13, the rest of SfM")


def sfm_expanding(input_sfm: str, features_folder: str, tracks_file: str, output_sfm: str, device="cuda"):
    _not_ported("sfmExpanding (sfm/expansion.py)", "13, the rest of SfM")


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
