"""The long tail of `av-torch` subcommands: the `command` registry.

Port of `alicevision_tpu/pipeline/cli_ext.py`: every subcommand of the
reference's registry keeps its parser (the same flags and defaults), so
`build_parser` is the reference's whole parser, and every subcommand runs.
Handlers compute on `args.dev`, the device `cli.py` resolved.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_COMMANDS: list = []  # (name, setup_fn, handler_fn), in the reference's order


def command(name, setup):
    def deco(fn):
        _COMMANDS.append((name, setup, fn))
        return fn

    return deco


def register(sub, add_common) -> None:
    for name, setup, handler in _COMMANDS:
        p = sub.add_parser(name)
        setup(p)
        add_common(p)
        p.set_defaults(_handler=handler)


def _ensure_parent(path):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def _setup_merge(p):
    p.add_argument("--input", required=True)
    p.add_argument("--input2", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--alignment", action="store_true",
                   help="align the second scene onto the first before merging")


def _sfm_merge(args):
    """ref: src/software/utils/main_sfmMerge.cpp"""
    from .. import sfmdata
    from ..sfmdata.merge import merge_scenes

    out = merge_scenes(sfmdata.load(args.input), sfmdata.load(args.input2), align=args.alignment)
    sfmdata.save(out, args.output)
    print(json.dumps({"views": out.n_views, "landmarks": out.n_landmarks}))


command("sfmMerge", _setup_merge)(_sfm_merge)


def _setup_split(p):
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True, help="reconstructed part")
    p.add_argument("--outputNonReconstructed", default=None)


def _sfm_split(args):
    """ref: src/software/utils/main_sfmSplitReconstructed.cpp"""
    from .. import sfmdata
    from ..sfmdata.merge import split_reconstructed

    rec, non = split_reconstructed(sfmdata.load(args.input))
    sfmdata.save(rec, args.output)
    if args.outputNonReconstructed:
        sfmdata.save(non, args.outputNonReconstructed)


command("sfmSplitReconstructed", _setup_split)(_sfm_split)


def _setup_align(p):
    p.add_argument("--input", required=True)
    p.add_argument("--reference", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--noScale", action="store_true")


def _sfm_alignment(args):
    """ref: src/software/utils/main_sfmAlignment.cpp"""
    from .. import sfmdata
    from ..sfm.alignment import align_to_scene

    sc = sfmdata.load(args.input)
    align_to_scene(sc, sfmdata.load(args.reference), with_scale=not args.noScale)
    sfmdata.save(sc, args.output)


command("sfmAlignment", _setup_align)(_sfm_alignment)


def _setup_transfer(p):
    p.add_argument("--input", required=True)
    p.add_argument("--reference", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--method", default="from_viewid",
                   choices=["from_viewid", "from_filepath"])
    p.add_argument("--transferPoses", action="store_true", default=True)
    p.add_argument("--transferIntrinsics", action="store_true")


def _sfm_transfer(args):
    """ref: src/software/utils/main_sfmTransfer.cpp"""
    from .. import sfmdata
    from ..sfm.transfer import transfer_intrinsics, transfer_poses

    sc = sfmdata.load(args.input)
    ref = sfmdata.load(args.reference)
    by = "filename" if args.method == "from_filepath" else "viewId"
    n_pose = transfer_poses(sc, ref, match_by=by) if args.transferPoses else 0
    n_intr = transfer_intrinsics(sc, ref, match_by=by) if args.transferIntrinsics else 0
    sfmdata.save(sc, args.output)
    print(json.dumps({"poses": n_pose, "intrinsics": n_intr}))


command("sfmTransfer", _setup_transfer)(_sfm_transfer)


def _setup_applycal(p):
    p.add_argument("--input", required=True)
    p.add_argument("--calibration", required=True,
                   help="calibrated .sfm or checkerboardCalibration .json")
    p.add_argument("--output", required=True)


def _apply_calibration(args):
    """ref: src/software/utils/main_applyCalibration.cpp"""
    from .. import sfmdata
    from ..sfm.transfer import apply_calibration

    sc = sfmdata.load(args.input)
    n = apply_calibration(sc, args.calibration)
    sfmdata.save(sc, args.output)
    print(json.dumps({"intrinsics_updated": n}))


command("applyCalibration", _setup_applycal)(_apply_calibration)


def _setup_distances(p):
    p.add_argument("--input", required=True)
    p.add_argument("--landmarksA", default="", help="comma-separated ids")
    p.add_argument("--landmarksB", default="", help="comma-separated ids")


def _sfm_distances(args):
    """ref: src/software/utils/main_sfmDistances.cpp"""
    import numpy as np

    from .. import sfmdata
    from ..sfm.transfer import landmark_distances

    sc = sfmdata.load(args.input)
    if args.landmarksA and args.landmarksB:
        a = [int(x) for x in args.landmarksA.split(",")]
        b = [int(x) for x in args.landmarksB.split(",")]
        print(json.dumps({"distances": landmark_distances(sc, a, b)}))
    else:
        ext = sc.points.max(0) - sc.points.min(0) if sc.n_landmarks else np.zeros(3)
        print(json.dumps({"bbox_extent": [float(x) for x in ext]}))


command("sfmDistances", _setup_distances)(_sfm_distances)


def _setup_regression(p):
    p.add_argument("--input", required=True)
    p.add_argument("--reference", required=True)
    p.add_argument("--maxRotationDeg", type=float, default=1.0)
    p.add_argument("--maxCenterDist", type=float, default=0.1)


def _sfm_regression(args):
    """ref: src/software/utils/main_sfmRegression.cpp"""
    from .. import sfmdata
    from ..sfm.transfer import compare_scenes

    rep = compare_scenes(sfmdata.load(args.input), sfmdata.load(args.reference))
    print(json.dumps(rep, indent=1))
    if not (rep["rotation_deg_max"] <= args.maxRotationDeg and rep["center_dist_max"] <= args.maxCenterDist):
        sys.exit(2)


command("sfmRegression", _setup_regression)(_sfm_regression)


def _setup_harmonize(p):
    p.add_argument("--input", required=True, help=".sfm")
    p.add_argument("--features", required=True, help="features folder")
    p.add_argument("--matches", required=True)
    p.add_argument("--imagesFolder", required=True)
    p.add_argument("--output", required=True, help="folder of harmonized images")


def _sfm_color_harmonize(args):
    """Gain/offset color consistency across matched views
    (ref: src/software/pipeline/main_sfmColorHarmonize.cpp,
    colorHarmonization/GainOffsetConstraintBuilder.cpp). Per-pair matched
    quantiles feed the IRLS gain/offset solve on the device."""
    import numpy as np

    from .. import sfmdata
    from ..image.io import read_image, write_image
    from ..misc.color_harmonization import harmonize_gains, matched_quantile_constraints
    from .stages import load_features, load_matches

    sc = sfmdata.load(args.input)
    matches = load_matches(args.matches)
    imgs = {}
    for v in range(sc.n_views):
        path = sc.view_paths[v]
        if path and os.path.exists(path):
            imgs[v] = read_image(path, grayscale=True)
    feats = {}

    def get_xy(v):
        if v not in feats:
            feats[v] = load_features(args.features, int(sc.view_ids[v]))["xy"]
        return feats[v]

    edges, mi, mj = [], [], []
    for (i, j), m in matches.items():
        if i not in imgs or j not in imgs or len(m) == 0:
            continue
        # matched-region quantiles around the matched feature patches
        # (GainOffsetConstraintBuilder histogram constraints)
        q_i, q_j = matched_quantile_constraints(imgs[i], imgs[j], get_xy(i)[m[:, 0]], get_xy(j)[m[:, 1]])
        for a, b in zip(q_i, q_j):
            edges.append((i, j))
            mi.append(float(a))
            mj.append(float(b))
    if not edges:
        raise RuntimeError("no usable pairs for harmonization")
    gains, offsets = harmonize_gains(sc.n_views, np.asarray(edges), np.asarray(mi, np.float32),
                                     np.asarray(mj, np.float32), device=args.dev)
    os.makedirs(args.output, exist_ok=True)
    g, o = gains.cpu().numpy(), offsets.cpu().numpy()
    for v, img in imgs.items():
        out = np.clip(img * g[v] + o[v], 0.0, 1.0)
        write_image(os.path.join(args.output, f"{int(sc.view_ids[v])}.png"), out)
    print(json.dumps({"views": len(imgs)}))


command("sfmColorHarmonize", _setup_harmonize)(_sfm_color_harmonize)


def _setup_relpose(p):
    p.add_argument("--input", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--matches", required=True)
    p.add_argument("--output", required=True, help="relative poses .npz")


@command("relativePoseEstimating", _setup_relpose)
def _relative_pose_estimating(args):
    """Per-pair essential decomposition
    (ref: src/software/pipeline/main_relativePoseEstimating.cpp). The
    RANSAC samples come from one generator seeded 0, a pair after another."""
    import numpy as np
    import torch

    from .. import camera as camm
    from .. import robust, sfmdata
    from .stages import load_features, load_matches

    sc = sfmdata.load(args.input)
    matches = load_matches(args.matches)
    intr = sc.intrinsics_table(device=args.dev)
    gen = torch.Generator(device=args.dev).manual_seed(0)
    edges, R_rel, dirs, n_inl = [], [], [], []
    feats = {}

    def get(v):
        if v not in feats:
            feats[v] = load_features(args.features, int(sc.view_ids[v]))
        return feats[v]

    def norm_pts(f, v, idx):
        row = intr.row(int(sc.view_intrinsic[v]))
        p = camm.ima2cam(row, torch.as_tensor(f["xy"][idx], dtype=torch.float32, device=args.dev))
        return camm.remove_distortion(row.disto_kind, row.disto, p)

    for (i, j), m in matches.items():
        if len(m) < 8:
            continue
        x1 = norm_pts(get(i), i, m[:, 0])
        x2 = norm_pts(get(j), j, m[:, 1])
        f_mean = float(np.mean(sc.scale[int(sc.view_intrinsic[i])]))
        w, h = float(sc.view_sizes[i, 0]), float(sc.view_sizes[i, 1])
        R, t, rm = robust.robust_relative_pose(gen, x1, x2, f_mean, (w, h))
        inl = int(rm.inliers.sum())
        if inl < 12:
            continue
        R, t = R.cpu().numpy(), t.cpu().numpy()
        edges.append((i, j))
        R_rel.append(R)
        # direction of c_j - c_i in camera-i frame: -R^T t normalized
        d = -R.T @ t
        dirs.append(d / max(np.linalg.norm(d), 1e-12))
        n_inl.append(inl)
    _ensure_parent(args.output)
    np.savez_compressed(
        args.output,
        edges=np.asarray(edges, np.int64).reshape(-1, 2),
        R_rel=np.asarray(R_rel).reshape(-1, 3, 3),
        dirs=np.asarray(dirs).reshape(-1, 3),
        inliers=np.asarray(n_inl, np.int64),
    )
    print(json.dumps({"pairs": len(edges)}))


def _setup_globalsfm(p):
    p.add_argument("--input", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--matches", required=True)
    p.add_argument("--relativePoses", default=None,
                   help="precomputed .npz from relativePoseEstimating")
    p.add_argument("--output", required=True)
    p.add_argument("--minTrackLength", type=int, default=2)


@command("globalSfM", _setup_globalsfm)
def _global_sfm(args):
    """Rotation/translation averaging reconstruction
    (ref: src/software/pipeline/main_globalSfM.cpp,
    sfm/pipeline/global/ReconstructionEngine_globalSfM.hpp:36-53)."""
    import numpy as np

    from .. import sfmdata
    from ..sfm.global_sfm import GlobalSfM
    from ..sfm.incremental import IncrementalConfig, IncrementalSfM
    from ..tracks.builder import build_tracks
    from .stages import load_features, load_matches

    sc = sfmdata.load(args.input)
    rel = args.relativePoses
    if not (rel and os.path.exists(rel)):
        rel = args.output + ".relposes.npz"
        _relative_pose_estimating(argparse.Namespace(input=args.input, features=args.features,
                                                     matches=args.matches, output=rel, dev=args.dev))
    with np.load(rel) as z:
        edges, R_rel, dirs = z["edges"], z["R_rel"], z["dirs"]
    if len(edges) < 1:
        raise RuntimeError("no relative poses")
    eng = GlobalSfM(sc.n_views, sc.intrinsics_table(), sc.view_intrinsic, sc.view_sizes, device=args.dev)
    R, c = eng.run(edges, R_rel, dirs)
    for v in range(sc.n_views):
        sc.set_pose(v, np.asarray(R[v], np.float64), np.asarray(c[v], np.float64))

    # triangulate tracks against the averaged poses, then one global BA
    matches = load_matches(args.matches)
    feats = {v: load_features(args.features, int(sc.view_ids[v])) for v in range(sc.n_views)}
    tracks = build_tracks(matches, {v: len(feats[v]["xy"]) for v in feats}, min_track_length=args.minTrackLength)
    engine = IncrementalSfM(
        tracks, {v: feats[v]["xy"] for v in feats}, sc.intrinsics_table(),
        view_intrinsic=sc.view_intrinsic, image_sizes=sc.view_sizes,
        config=IncrementalConfig(), device=args.dev,
    )
    for v in range(sc.n_views):
        engine.res.pose_R[v] = np.asarray(R[v])
        engine.res.pose_c[v] = np.asarray(c[v])
        engine.res.posed[v] = True
    engine.triangulate_all()
    engine.bundle_adjust()
    engine.remove_outliers()
    out = engine.to_sfmdata(view_ids=sc.view_ids)
    out.view_paths = list(sc.view_paths)
    sfmdata.save(out, args.output)
    print(json.dumps({"poses": int(engine.res.posed.sum()), "landmarks": out.n_landmarks}))


def _setup_triangulate(p):
    p.add_argument("--input", required=True, help="posed .sfm")
    p.add_argument("--features", required=True)
    p.add_argument("--tracks", default=None, help="tracks .npz")
    p.add_argument("--matches", default=None, help="or matches .npz")
    p.add_argument("--output", required=True)
    p.add_argument("--minTrackLength", type=int, default=2)


def _triangulate_known_poses(args):
    """Triangulate the tracks of a posed scene with its poses held
    (ref: src/software/pipeline/main_sfmTriangulation.cpp,
    main_computeStructureFromKnownPoses.cpp)."""
    import numpy as np

    from .. import sfmdata
    from ..sfm.incremental import IncrementalConfig, IncrementalSfM
    from ..tracks.builder import Tracks, build_tracks
    from .stages import load_features, load_matches

    sc = sfmdata.load(args.input)
    feats = {v: load_features(args.features, int(sc.view_ids[v])) for v in range(sc.n_views)}
    if args.tracks:
        with np.load(args.tracks) as z:
            tracks = Tracks(z["track_ids"], z["views"], z["features"], int(z["n_tracks"]))
    elif args.matches:
        tracks = build_tracks(load_matches(args.matches), {v: len(feats[v]["xy"]) for v in feats},
                              min_track_length=args.minTrackLength)
    else:
        raise RuntimeError("give --tracks or --matches")
    engine = IncrementalSfM(
        tracks, {v: feats[v]["xy"] for v in feats}, sc.intrinsics_table(),
        view_intrinsic=sc.view_intrinsic, image_sizes=sc.view_sizes,
        config=IncrementalConfig(), device=args.dev,
    )
    for v in range(sc.n_views):
        p = int(sc.view_pose[v])
        if p >= 0:
            engine.res.pose_R[v] = sc.pose_R[p]
            engine.res.pose_c[v] = sc.pose_c[p]
            engine.res.posed[v] = True
    engine.triangulate_all()
    out = engine.to_sfmdata(view_ids=sc.view_ids)
    out.view_paths = list(sc.view_paths)
    sfmdata.save(out, args.output)
    print(json.dumps({"landmarks": out.n_landmarks}))


command("sfmTriangulation", _setup_triangulate)(_triangulate_known_poses)


command("computeStructureFromKnownPoses", _setup_triangulate)(_triangulate_known_poses)


def _setup_select_connected(p):
    p.add_argument("--input", required=True)
    p.add_argument("--matches", required=True)
    p.add_argument("--output", required=True, help="kept view-id list file")
    p.add_argument("--minLinks", type=int, default=1)


def _select_connected_views(args):
    """ref: src/software/pipeline/main_selectConnectedViews.cpp"""
    import numpy as np

    from .. import sfmdata
    from .stages import load_matches

    sc = sfmdata.load(args.input)
    links = np.zeros(sc.n_views, np.int64)
    for (i, j), m in load_matches(args.matches).items():
        if len(m):
            links[i] += 1
            links[j] += 1
    keep = np.nonzero(links >= args.minLinks)[0]
    _ensure_parent(args.output)
    with open(args.output, "w") as f:
        for v in keep:
            f.write(f"{int(sc.view_ids[v])}\n")
    print(json.dumps({"kept": len(keep), "total": sc.n_views}))


command("selectConnectedViews", _setup_select_connected)(_select_connected_views)


def _setup_frustum(p):
    p.add_argument("--input", required=True, help="posed .sfm")
    p.add_argument("--output", required=True, help="pair list file")
    p.add_argument("--zNear", type=float, default=None)
    p.add_argument("--zFar", type=float, default=None)


def _frustum_filtering(args):
    """ref: src/software/pipeline/main_frustumFiltering.cpp"""
    from .. import sfmdata
    from ..sfm.frustum import frustum_pairs

    pairs = frustum_pairs(sfmdata.load(args.input), z_near=args.zNear, z_far=args.zFar, device=args.dev)
    _ensure_parent(args.output)
    with open(args.output, "w") as f:
        for i, j in pairs:
            f.write(f"{i} {j}\n")
    print(json.dumps({"pairs": int(len(pairs))}))


command("frustumFiltering", _setup_frustum)(_frustum_filtering)


def _setup_colored_cloud(p):
    p.add_argument("--input", required=True)
    p.add_argument(
        "--imagesFolder",
        default="",
        help="prepared-image folder (<viewId>.npy); when given, landmarks "
        "are colorized from observation pixels before export",
    )
    p.add_argument("--output", required=True, help=".ply")


def _export_colored_point_cloud(args):
    """Colorize landmarks from their observation pixels (colorizeTracks
    greedy view assignment) and write the colored PLY.
    ref: src/software/export/main_exportColoredPointCloud.cpp,
    src/aliceVision/sfmData/colorize.cpp:23-123"""
    from .. import sfmdata

    sc = sfmdata.load(args.input)
    if args.imagesFolder:
        sfmdata.colorize_tracks(sc, sfmdata.npy_folder_loader(sc, args.imagesFolder))
    _ensure_parent(args.output)
    sfmdata.save_ply(sc, args.output)
    print(json.dumps({"points": int(len(sc.points)), "colorized": bool(args.imagesFolder)}))


command("exportColoredPointCloud", _setup_colored_cloud)(_export_colored_point_cloud)


def _setup_export_keypoints(p):
    p.add_argument("--input", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--output", required=True, help="folder of SVGs")


@command("exportKeypoints", _setup_export_keypoints)
def _export_keypoints(args):
    """ref: src/software/export/main_exportKeypoints.cpp"""
    from .. import sfmdata
    from ..utils.svg import write_keypoints_svg
    from .stages import load_features

    sc = sfmdata.load(args.input)
    os.makedirs(args.output, exist_ok=True)
    n = 0
    for v in range(sc.n_views):
        try:
            f = load_features(args.features, int(sc.view_ids[v]))
        except FileNotFoundError:
            continue
        write_keypoints_svg(
            os.path.join(args.output, f"{int(sc.view_ids[v])}.svg"),
            sc.view_sizes[v], f["xy"][f["valid"]],
            scale=f.get("scale", [2.0] * len(f["xy"])),
            image_path=sc.view_paths[v] or None,
        )
        n += 1
    print(json.dumps({"views": n}))


def _setup_export_matches(p):
    p.add_argument("--input", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--matches", required=True)
    p.add_argument("--output", required=True, help="folder of SVGs")


@command("exportMatches", _setup_export_matches)
def _export_matches(args):
    """ref: src/software/export/main_exportMatches.cpp"""
    from .. import sfmdata
    from ..utils.svg import write_matches_svg
    from .stages import load_features, load_matches

    sc = sfmdata.load(args.input)
    os.makedirs(args.output, exist_ok=True)
    feats = {}

    def get(v):
        if v not in feats:
            feats[v] = load_features(args.features, int(sc.view_ids[v]))
        return feats[v]

    n = 0
    for (i, j), m in load_matches(args.matches).items():
        if not len(m):
            continue
        fi, fj = get(i), get(j)
        write_matches_svg(
            os.path.join(args.output, f"{int(sc.view_ids[i])}_{int(sc.view_ids[j])}.svg"),
            sc.view_sizes[i], sc.view_sizes[j],
            fi["xy"][m[:, 0]], fj["xy"][m[:, 1]],
            image1=sc.view_paths[i] or None, image2=sc.view_paths[j] or None,
        )
        n += 1
    print(json.dumps({"pairs": n}))


def _setup_export_tracks(p):
    p.add_argument("--input", required=True)
    p.add_argument("--tracks", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--output", required=True, help="SVG path")
    p.add_argument("--maxTracks", type=int, default=500)


@command("exportTracks", _setup_export_tracks)
def _export_tracks(args):
    """ref: src/software/export/main_exportTracks.cpp"""
    import numpy as np

    from .. import sfmdata
    from ..tracks.builder import Tracks
    from ..utils.svg import write_tracks_svg
    from .stages import load_features

    sc = sfmdata.load(args.input)
    with np.load(args.tracks) as z:
        tr = Tracks(z["track_ids"], z["views"], z["features"], int(z["n_tracks"]))
    feats = {v: load_features(args.features, int(sc.view_ids[v])) for v in range(sc.n_views)}
    polylines = []
    order = np.argsort(tr.track_ids, kind="stable")
    tids = tr.track_ids[order]
    vs = tr.views[order]
    fs = tr.features[order]
    starts = np.searchsorted(tids, np.unique(tids))
    bounds = np.append(starts, len(tids))
    for k in range(min(args.maxTracks, len(starts))):
        sl = slice(bounds[k], bounds[k + 1])
        line = [feats[int(v)]["xy"][int(f)] for v, f in zip(vs[sl], fs[sl])]
        if len(line) >= 2:
            polylines.append(line)
    _ensure_parent(args.output)
    write_tracks_svg(args.output, sc.view_sizes[0], polylines)
    print(json.dumps({"tracks": len(polylines)}))


def _setup_import_middlebury(p):
    p.add_argument("--input", required=True, help="*_par.txt")
    p.add_argument("--imagesFolder", default=None)
    p.add_argument("--output", required=True, help=".sfm")


@command("importMiddlebury", _setup_import_middlebury)
def _import_middlebury(args):
    """ref: src/software/pipeline/main_importMiddlebury.cpp"""
    from .. import sfmdata
    from ..sfmdata.middlebury import import_middlebury

    sc = import_middlebury(args.input, args.imagesFolder)
    sfmdata.save(sc, args.output)
    print(json.dumps({"views": sc.n_views}))


def _setup_sample_scene(p):
    p.add_argument("--output", required=True, help=".sfm")
    p.add_argument("--nbViews", type=int, default=10)
    p.add_argument("--nbPoints", type=int, default=100)
    p.add_argument("--noisePx", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)


def _generate_sample_scene(args):
    """ref: src/software/utils/main_generateSampleScene.cpp,
    sfmDataIO/sceneSample.hpp:18. The points and the noise come from a
    torch generator seeded with --seed: the scene is the reference's up to
    those draws (`utils/synthetic.py`)."""
    from .. import sfmdata
    from ..utils.synthetic import ring_scene_sfmdata

    sc = ring_scene_sfmdata(n_views=args.nbViews, n_points=args.nbPoints, noise_px=args.noisePx, seed=args.seed,
                            device=args.dev)
    _ensure_parent(args.output)
    sfmdata.save(sc, args.output)
    print(json.dumps({"views": sc.n_views, "landmarks": sc.n_landmarks}))


command("generateSampleScene", _setup_sample_scene)(_generate_sample_scene)


def _setup_voctree_query(p):
    p.add_argument("--tree", required=True, help="tree .npz from voctreeCreation")
    p.add_argument("--input", required=True, help=".sfm")
    p.add_argument("--features", required=True)
    p.add_argument("--output", default=None, help="pair list file")
    p.add_argument("--nbNeighbors", type=int, default=10)


@command("voctreeQueryUtility", _setup_voctree_query)
def _voctree_query(args):
    """ref: src/software/utils/main_voctreeQueryUtility.cpp"""
    import numpy as np
    import torch

    from .. import sfmdata
    from ..matching import voctree as vt
    from .stages import load_features

    sc = sfmdata.load(args.input)
    with np.load(args.tree) as z:
        tree = vt.VocTree(centers=torch.from_numpy(z["centers"]).to(args.dev), n_children=int(z["n_children"]),
                          n_levels=int(z["n_levels"]))
    bows = []
    for v in range(sc.n_views):
        f = load_features(args.features, int(sc.view_ids[v]))
        bows.append(vt.bow_vector(tree, torch.from_numpy(f["desc"]).to(args.dev),
                                  torch.from_numpy(f["valid"]).to(args.dev)))
    db = vt.build_database(tree, torch.stack(bows))
    pairs = vt.query_pairs(db, n_neighbors=args.nbNeighbors)
    if args.output:
        _ensure_parent(args.output)
        with open(args.output, "w") as f:
            for i, j in pairs:
                f.write(f"{i} {j}\n")
    print(json.dumps({"pairs": int(len(pairs))}))


def _setup_voctree_stats(p):
    p.add_argument("--tree", required=True)


@command("voctreeStatistics", _setup_voctree_stats)
def _voctree_statistics(args):
    """ref: src/software/utils/main_voctreeStatistics.cpp (host numpy)"""
    import numpy as np

    with np.load(args.tree) as z:
        centers = z["centers"]
        k = int(z["n_children"])
        levels = int(z["n_levels"])
    print(json.dumps({
        "levels": levels,
        "branching": k,
        "leaves": int(k ** levels),
        "nodes_per_level": int(centers.shape[1]),
        "descriptor_dim": int(centers.shape[-1]),
        "mean_center_norm": float(np.linalg.norm(centers, axis=-1).mean()),
    }))


def _setup_depth_render(p):
    p.add_argument("--input", required=True, help="posed .sfm")
    p.add_argument("--mesh", required=True)
    p.add_argument("--output", required=True, help="folder of <viewId>_depth.npy")
    p.add_argument("--downscale", type=int, default=4)


def _scene_cams(sc, downscale=1):
    cams = []
    for v in sc.valid_views():
        K, R, c = sc.camera_matrices(v)
        w, h = sc.view_sizes[v]
        if downscale > 1:
            K = K.copy()
            K[:2] /= downscale
            w, h = w // downscale, h // downscale
        cams.append((int(sc.view_ids[v]), K, R, c, (int(h), int(w))))
    return cams


def _depth_map_rendering(args):
    """ref: src/software/pipeline/main_depthMapRendering.cpp"""
    import numpy as np

    from .. import sfmdata
    from ..mesh import load_obj
    from ..mesh.render import render_depth_map

    sc = sfmdata.load(args.input)
    V, F = load_obj(args.mesh)
    os.makedirs(args.output, exist_ok=True)
    n = 0
    for vid, K, R, c, hw in _scene_cams(sc, args.downscale):
        depth, _ = render_depth_map(V, F, K, R, c, hw, device=args.dev)
        np.save(os.path.join(args.output, f"{vid}_depth.npy"), depth)
        n += 1
    print(json.dumps({"rendered": n}))


command("depthMapRendering", _setup_depth_render)(_depth_map_rendering)


def _setup_normal_render(p):
    p.add_argument("--input", required=True, help="posed .sfm")
    p.add_argument("--mesh", required=True)
    p.add_argument("--output", required=True, help="folder of <viewId>_normal.npy")
    p.add_argument("--downscale", type=int, default=4)
    p.add_argument("--worldFrame", action="store_true")


def _normal_map_rendering(args):
    """ref: src/software/pipeline/main_normalMapRendering.cpp"""
    import numpy as np

    from .. import sfmdata
    from ..mesh import load_obj
    from ..mesh.render import render_normal_map

    sc = sfmdata.load(args.input)
    V, F = load_obj(args.mesh)
    os.makedirs(args.output, exist_ok=True)
    n = 0
    for vid, K, R, c, hw in _scene_cams(sc, args.downscale):
        normals, _ = render_normal_map(V, F, K, R, c, hw, camera_frame=not args.worldFrame, device=args.dev)
        np.save(os.path.join(args.output, f"{vid}_normal.npy"), normals)
        n += 1
    print(json.dumps({"rendered": n}))


command("normalMapRendering", _setup_normal_render)(_normal_map_rendering)


def _setup_unseen(p):
    p.add_argument("--input", required=True, help="posed .sfm")
    p.add_argument("--mesh", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--minObservations", type=int, default=1)
    p.add_argument("--downscale", type=int, default=4)


def _mesh_remove_unseen(args):
    """ref: src/software/pipeline/main_meshRemoveUnseenFaces.cpp"""
    from .. import sfmdata
    from ..mesh import load_obj, save_obj
    from ..mesh.render import remove_unseen_faces

    sc = sfmdata.load(args.input)
    V, F = load_obj(args.mesh)
    cams = [(K, R, c, hw) for _, K, R, c, hw in _scene_cams(sc, args.downscale)]
    V2, F2 = remove_unseen_faces(V, F, cams, min_views=args.minObservations, device=args.dev)
    save_obj(args.output, V2, F2)
    print(json.dumps({"faces_in": int(len(F)), "faces_out": int(len(F2))}))


command("meshRemoveUnseenFaces", _setup_unseen)(_mesh_remove_unseen)


def _setup_merge_meshes(p):
    p.add_argument("--input", required=True)
    p.add_argument("--input2", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--weldEps", type=float, default=0.0)


def _merge_meshes(args):
    """ref: src/software/pipeline/main_mergeMeshes.cpp"""
    from ..mesh import load_obj, merge_meshes, save_obj

    v1, f1 = load_obj(args.input)
    v2, f2 = load_obj(args.input2)
    v, f = merge_meshes(v1, f1, v2, f2, weld_eps=args.weldEps)
    save_obj(args.output, v, f)
    print(json.dumps({"vertices": int(len(v)), "faces": int(len(f))}))


command("mergeMeshes", _setup_merge_meshes)(_merge_meshes)


def _setup_checker_detect(p):
    p.add_argument("--input", required=True, help="image or folder")
    p.add_argument("--output", required=True, help="corners .json")
    p.add_argument("--rows", type=int, required=True)
    p.add_argument("--cols", type=int, required=True)


def _image_paths(folder):
    """The folder's images (`_list_queries`) as paths."""
    return [os.path.join(folder, f) for f in _list_queries(folder)]


def _folder_or_file(path):
    return _image_paths(path) if os.path.isdir(path) else [path]


def _checkerboard_detection(args):
    """ref: src/software/pipeline/main_checkerboardDetection.cpp,
    calibration/checkerDetector.cpp"""
    import numpy as np

    from ..calibration import detect_checkerboard
    from ..image.io import read_image

    files = _folder_or_file(args.input)
    out = {}
    for path in files:
        g = detect_checkerboard(read_image(path, grayscale=True), args.rows, args.cols, device=args.dev)
        if g is not None:
            out[os.path.basename(path)] = np.asarray(g).tolist()
    _ensure_parent(args.output)
    with open(args.output, "w") as f:
        json.dump({"rows": args.rows, "cols": args.cols, "detections": out}, f)
    print(json.dumps({"detected": len(out), "images": len(files)}))


command("checkerboardDetection", _setup_checker_detect)(_checkerboard_detection)


def _setup_camera_calibration(p):
    p.add_argument("--input", required=True, help="image folder")
    p.add_argument("--output", required=True, help="calibration .json")
    p.add_argument("--rows", type=int, required=True)
    p.add_argument("--cols", type=int, required=True)
    p.add_argument("--squareSize", type=float, default=1.0)


def checkerboard_calibration(folder, rows, cols, square_size, dev):
    """Zhang calibration of the checkerboard grids found in `folder`'s
    images (at least 3): (calibrate_zhang's dict, views used)."""
    import numpy as np

    from ..calibration import calibrate_zhang, detect_checkerboard
    from ..image.io import read_image

    grids = []
    for path in _image_paths(folder):
        g = detect_checkerboard(read_image(path, grayscale=True), rows, cols, device=dev)
        if g is not None:
            grids.append(np.asarray(g))
    if len(grids) < 3:
        raise RuntimeError(f"checkerboard found in only {len(grids)} images")
    obj = square_size * np.array([[i, j] for j in range(rows) for i in range(cols)], float)
    return calibrate_zhang(obj, np.stack(grids), device=dev), len(grids)


def _camera_calibration(args):
    """Zhang calibration over a checkerboard sequence
    (ref: src/software/pipeline/main_cameraCalibration.cpp)."""
    res, n = checkerboard_calibration(args.input, args.rows, args.cols, args.squareSize, args.dev)
    _ensure_parent(args.output)
    with open(args.output, "w") as f:
        json.dump({"K": res["K"].tolist(), "dist": res["dist"].tolist(), "rms": res["rms"], "n_views": n}, f,
                  indent=1)
    print(json.dumps({"rms": res["rms"], "views": n}))


command("cameraCalibration", _setup_camera_calibration)(_camera_calibration)


def _setup_disto_calib(p):
    p.add_argument("--input", required=True, help=".sfm")
    p.add_argument("--checkerboards", required=True,
                   help="corners .json from checkerboardDetection")
    p.add_argument("--output", required=True, help=".sfm with distortion")
    p.add_argument("--nbParams", type=int, default=3)
    p.add_argument("--undistortionModelName", default="none",
                   choices=["none", "radialk3", "3deanamorphic4",
                            "3declassicld", "3deradial4"],
                   help="fit an Undistortion-family (3DE) model instead of "
                        "the RADIALK3 distortion "
                        "(ref: main_distortionCalibration.cpp)")


def _distortion_calibration(args):
    """Distortion from checkerboard line straightness
    (ref: src/software/pipeline/main_distortionCalibration.cpp,
    calibration/distortionEstimationLine.cpp)."""
    import numpy as np

    from .. import camera as camm
    from .. import sfmdata
    from ..calibration.distortion_lines import calibrate_distortion_from_lines, calibrate_undistortion_from_lines
    from ..camera import undistortion as und

    sc = sfmdata.load(args.input)
    with open(args.checkerboards) as f:
        data = json.load(f)
    rows, cols = data["rows"], data["cols"]
    lines = []
    for det in data["detections"].values():
        g = np.asarray(det, float).reshape(rows, cols, 2)
        lines += [g[r] for r in range(rows)] + [g[:, c] for c in range(cols)]
    n = max(rows, cols)
    pts = np.zeros((len(lines), n, 2))
    mask = np.zeros((len(lines), n), bool)
    for k, ln in enumerate(lines):
        pts[k, :len(ln)] = ln
        mask[k, :len(ln)] = True
    if args.undistortionModelName != "none":
        kind = und.UNDIST_CODES[args.undistortionModelName]
        init = und.Undistortion.make(kind, int(sc.sizes[0, 0]), int(sc.sizes[0, 1]))
        fitted, rms_before, rms_after = calibrate_undistortion_from_lines(pts, mask, init, device=args.dev)
        for i in range(sc.n_intrinsics):
            und.set_scene_undistortion(sc, i, fitted)
    else:
        row = sc.intrinsics_table(device=args.dev).row(0)
        disto, rms_before, rms_after = calibrate_distortion_from_lines(pts, mask, row, n_params=args.nbParams,
                                                                       device=args.dev)
        for i in range(sc.n_intrinsics):
            sc.disto_kind[i] = camm.DISTO_RADIALK3
            sc.disto[i] = disto.cpu().numpy()
    sfmdata.save(sc, args.output)
    print(json.dumps({"rms_before": float(rms_before), "rms_after": float(rms_after)}))


command("distortionCalibration", _setup_disto_calib)(_distortion_calibration)


def _setup_convert_disto(p):
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--to", required=True,
                   choices=["none", "radialk1", "radialk3", "brown", "fisheye4",
                            "fisheye1"])


def _convert_distortion(args):
    """ref: src/software/convert/main_convertDistortion.cpp"""
    from .. import camera as camm
    from .. import sfmdata
    from ..camera.convert import convert_intrinsic_distortion

    name_to_kind = {"none": camm.DISTO_NONE, "radialk1": camm.DISTO_RADIALK1, "radialk3": camm.DISTO_RADIALK3,
                    "brown": camm.DISTO_BROWN, "fisheye4": camm.DISTO_FISHEYE, "fisheye1": camm.DISTO_FISHEYE1}
    sc = sfmdata.load(args.input)
    for i in range(sc.n_intrinsics):
        convert_intrinsic_distortion(sc, i, name_to_kind[args.to], device=args.dev)
    sfmdata.save(sc, args.output)
    print(json.dumps({"intrinsics": sc.n_intrinsics, "to": args.to}))


command("convertDistortion", _setup_convert_disto)(_convert_distortion)


def _setup_export_disto(p):
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True, help="output folder")


def _export_distortion(args):
    """Undistort/distort STMaps + Nuke script per intrinsic
    (ref: src/software/export/main_exportDistortion.cpp)."""
    import numpy as np

    from .. import sfmdata
    from ..camera import undistortion as und
    from ..camera.convert import distort_stmap, undistort_stmap

    sc = sfmdata.load(args.input)
    intr = sc.intrinsics_table(device=args.dev)
    os.makedirs(args.output, exist_ok=True)
    for i in range(sc.n_intrinsics):
        row = intr.row(i)
        iid = int(sc.intrinsic_ids[i])
        # maps capped near 1024 px: STMaps are resolution independent
        w, h = int(sc.sizes[i, 0]), int(sc.sizes[i, 1])
        s = max(1, max(w, h) // 1024)
        hh, ww = h // s, w // s
        np.save(os.path.join(args.output, f"{iid}_undistort_stmap.npy"), undistort_stmap(row, hw=(hh, ww)))
        np.save(os.path.join(args.output, f"{iid}_distort_stmap.npy"), distort_stmap(row, hw=(hh, ww)))
        # Undistortion-family (3DE) STMaps when present
        # (ref: main_exportDistortion.cpp undistortion branch)
        u = und.scene_undistortion(sc, i)
        if u is not None:
            yy, xx = np.meshgrid(np.arange(hh), np.arange(ww), indexing="ij")
            grid = (np.stack([xx, yy], -1).reshape(-1, 2) + 0.5) * np.array([w / ww, h / hh])
            fwd = und.undistort_pixels(u, grid, device=args.dev).cpu().numpy().reshape(hh, ww, 2)
            inv = und.inverse_pixels(u, grid, device=args.dev).cpu().numpy().reshape(hh, ww, 2)
            np.save(os.path.join(args.output, f"{iid}_undistortion_stmap.npy"), fwd / [w, h])
            np.save(os.path.join(args.output, f"{iid}_undistortion_inv_stmap.npy"), inv / [w, h])
        fx, fy = sc.scale[i]
        with open(os.path.join(args.output, f"{iid}_nuke.nk"), "w") as f:
            f.write("# LensDistortion node (AliceVision-compatible export)\n"
                    f"# intrinsic {iid}: fx={fx} fy={fy} disto={list(sc.disto[i])}\n")
    print(json.dumps({"intrinsics": sc.n_intrinsics}))


command("exportDistortion", _setup_export_disto)(_export_distortion)


def _setup_ps(p):
    p.add_argument("--inputFolder", required=True, help="images, one per light")
    p.add_argument("--lights", required=True,
                   help="lights .json ({\"directions\": [[x,y,z],...]}) or .npy")
    p.add_argument("--output", required=True, help="output folder")
    p.add_argument("--integrate", action="store_true", help="also write depth")


def _read_stack(folder, dev):
    import numpy as np
    import torch

    from ..image.io import read_image

    files = _list_queries(folder)
    imgs = np.stack([read_image(os.path.join(folder, f), grayscale=True) for f in files])
    return files, torch.as_tensor(imgs, dtype=torch.float32, device=dev)


def _photometric_stereo(args):
    """ref: src/software/pipeline/main_photometricStereo.cpp,
    photometricStereo/photometricStereo.cpp"""
    import numpy as np
    import torch

    from ..photometric import normal_integration_dct, photometric_stereo

    files, imgs = _read_stack(args.inputFolder, args.dev)
    if args.lights.endswith(".npy"):
        L = np.load(args.lights)
    else:
        with open(args.lights) as f:
            L = np.asarray(json.load(f)["directions"], float)
    normals, albedo = photometric_stereo(imgs, torch.as_tensor(L, dtype=torch.float32, device=args.dev))
    os.makedirs(args.output, exist_ok=True)
    np.save(os.path.join(args.output, "normals.npy"), normals.cpu().numpy())
    np.save(os.path.join(args.output, "albedo.npy"), albedo.cpu().numpy())
    if args.integrate:
        np.save(os.path.join(args.output, "depth.npy"), normal_integration_dct(normals).cpu().numpy())
    print(json.dumps({"images": len(files)}))


command("photometricStereo", _setup_ps)(_photometric_stereo)


def _setup_ni(p):
    p.add_argument("--input", required=True, help="normals .npy (H,W,3)")
    p.add_argument("--output", required=True, help="depth .npy")


def _normal_integration(args):
    """ref: src/software/pipeline/main_normalIntegration.cpp"""
    import numpy as np
    import torch

    from ..photometric import normal_integration_dct

    normals = torch.as_tensor(np.load(args.input), dtype=torch.float32, device=args.dev)
    _ensure_parent(args.output)
    np.save(args.output, normal_integration_dct(normals).cpu().numpy())


command("normalIntegration", _setup_ni)(_normal_integration)


def _setup_le(p):
    p.add_argument("--normals", required=True, help="normals .npy")
    p.add_argument("--image", required=True, help="shaded image")
    p.add_argument("--albedo", default=None)
    p.add_argument("--output", required=True, help="SH coefficients .json")


def _lighting_estimation(args):
    """ref: src/software/pipeline/main_lightingEstimation.cpp,
    lightingEstimation/lightingEstimation.cpp"""
    import numpy as np
    import torch

    from ..image.io import read_image
    from ..photometric import estimate_sh_lighting

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=args.dev)

    albedo = t(np.load(args.albedo)) if args.albedo else None
    L = estimate_sh_lighting(t(read_image(args.image, grayscale=True)), t(np.load(args.normals)), albedo=albedo)
    L = L.cpu().numpy()
    _ensure_parent(args.output)
    with open(args.output, "w") as f:
        json.dump({"sh": L.tolist()}, f)
    print(json.dumps({"sh_dim": int(L.shape[-1])}))


command("lightingEstimation", _setup_le)(_lighting_estimation)


def _setup_lc(p):
    p.add_argument("--inputFolder", required=True)
    p.add_argument("--sphere", default=None,
                   help="cx,cy,r — detected automatically when omitted")
    p.add_argument("--output", required=True, help="lights .json")


def _lighting_calibration(args):
    """ref: src/software/pipeline/main_lightingCalibration.cpp,
    lightingEstimation/lightingCalibration.cpp (brightestPoint)"""
    from ..image.io import read_image
    from ..misc.sphere_detection import detect_sphere
    from ..photometric.light_calibration import calibrate_light_from_sphere

    dirs = []
    for path in _image_paths(args.inputFolder):
        img = read_image(path, grayscale=True)
        if args.sphere:
            cx, cy, r = [float(x) for x in args.sphere.split(",")]
        else:
            det = detect_sphere(img)
            if det is None:
                continue
            cx, cy, r = det[0], det[1], det[2]
        dirs.append(calibrate_light_from_sphere(img, cx, cy, r, device=args.dev).tolist())
    _ensure_parent(args.output)
    with open(args.output, "w") as f:
        json.dump({"directions": dirs}, f)
    print(json.dumps({"lights": len(dirs)}))


command("lightingCalibration", _setup_lc)(_lighting_calibration)


def _setup_sphere(p):
    p.add_argument("--input", required=True, help="image")
    p.add_argument("--output", required=True, help="detection .json")
    p.add_argument("--minRadius", type=int, default=8)
    p.add_argument("--maxRadius", type=int, default=64)


def _sphere_detection(args):
    """ref: src/software/pipeline/main_sphereDetection.cpp (classical Hough
    voting on the host in place of the reference's ONNX model)."""
    from ..image.io import read_image
    from ..misc.sphere_detection import detect_sphere

    det = detect_sphere(read_image(args.input, grayscale=True), r_min=args.minRadius, r_max=args.maxRadius)
    _ensure_parent(args.output)
    with open(args.output, "w") as f:
        json.dump({"found": det is not None, "sphere": list(det[:3]) if det else None,
                   "score": det[3] if det else 0.0}, f)
    print(json.dumps({"found": det is not None}))


command("sphereDetection", _setup_sphere)(_sphere_detection)


def _setup_image_masking(p):
    p.add_argument("--input", required=True, help="image or folder")
    p.add_argument("--output", required=True, help="mask png or folder")
    p.add_argument("--algorithm", default="hsv",
                   choices=["hsv", "autoGrayscaleThreshold"],
                   help="masking algorithm (ref main_imageMasking.cpp:95)")
    p.add_argument("--hsvMin", default="0,0,0")
    p.add_argument("--hsvMax", default="1,1,1")
    p.add_argument("--invert", action="store_true")
    p.add_argument("--growRadius", type=int, default=0,
                   help="dilate the mask (ref main_imageMasking.cpp:144)")
    p.add_argument("--shrinkRadius", type=int, default=0,
                   help="erode the mask (ref main_imageMasking.cpp:146)")


def _image_masking(args):
    """HSV-box / Otsu masking with grow/shrink postprocessing on the device
    (ref: src/software/pipeline/main_imageMasking.cpp,
    imageMasking/imageMasking.cpp)."""
    import numpy as np
    import torch

    from ..image.io import read_image, write_image
    from ..misc.masking import auto_threshold_mask, dilate, erode, hsv_mask

    lo = [float(x) for x in args.hsvMin.split(",")]
    hi = [float(x) for x in args.hsvMax.split(",")]
    if os.path.isdir(args.input):
        files = sorted(f for f in os.listdir(args.input) if f.lower().endswith((".jpg", ".png", ".jpeg", ".npy")))
        os.makedirs(args.output, exist_ok=True)
        pairs = [(os.path.join(args.input, f), os.path.join(args.output, os.path.splitext(f)[0] + "_mask.png"))
                 for f in files]
    else:
        pairs = [(args.input, args.output)]
    for src, dst in pairs:
        img = read_image(src)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        rgb = torch.from_numpy(np.ascontiguousarray(img)).to(args.dev)
        if args.algorithm == "autoGrayscaleThreshold":
            # the channels' mean, summed in their order on every device
            gray = rgb[..., 0]
            for c in range(1, rgb.shape[-1]):
                gray = gray + rgb[..., c]
            m = auto_threshold_mask(gray / rgb.shape[-1])
            if args.invert:
                m = ~m
        else:
            m = hsv_mask(rgb, h_range=(lo[0], hi[0]), s_range=(lo[1], hi[1]), v_range=(lo[2], hi[2]),
                         invert=args.invert)
        if args.growRadius > 0:
            m = dilate(m, args.growRadius)
        if args.shrinkRadius > 0:
            m = erode(m, args.shrinkRadius)
        write_image(dst, m.cpu().numpy().astype(np.float32))
    print(json.dumps({"masks": len(pairs)}))


command("imageMasking", _setup_image_masking)(_image_masking)


def _obs_descriptors(sc, features_folder):
    import numpy as np

    from .stages import load_features

    descs = {}
    for v in np.unique(sc.obs_view):
        descs[int(v)] = load_features(features_folder, int(sc.view_ids[v]))["desc"]
    return np.stack([descs[int(v)][int(f)] for v, f in zip(sc.obs_view, sc.obs_feature)]).astype(np.float32)


def _build_landmark_index_from_features(sc, features_folder):
    """Mean descriptor per landmark via obs (view, feature) ids."""
    from ..localization import build_landmark_index

    return build_landmark_index(sc.points, sc.obs_landmark, _obs_descriptors(sc, features_folder))


def _list_queries(folder):
    return sorted(f for f in os.listdir(folder) if f.lower().endswith((".jpg", ".png", ".jpeg", ".npy")))


def _query_features(path, row, dev, max_keypoints, downscale_to=0):
    """SIFT of one query image on `dev` (decimated by an integer step when
    larger than downscale_to, as the reference): (descriptors (N, D),
    undistorted normalized coordinates (N, 2)) on the host."""
    import numpy as np
    import torch

    from .. import camera as camm
    from ..features import sift as siftm
    from ..image.io import read_image

    img = read_image(path, grayscale=True)
    scale = 1.0
    if downscale_to and max(img.shape) > downscale_to:
        s = max(img.shape) // downscale_to + 1
        img = img[::s, ::s]
        scale = float(s)
    feats = siftm.extract(torch.as_tensor(np.ascontiguousarray(img), dtype=torch.float32, device=dev),
                          siftm.SiftConfig(max_keypoints=max_keypoints))
    valid = feats.valid
    p = camm.ima2cam(row, feats.xy[valid] * scale)
    p = camm.remove_distortion(row.disto_kind, row.disto, p)
    return feats.desc[valid].cpu().numpy(), p.cpu().numpy()


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _setup_camera_loc(p):
    p.add_argument("--input", required=True, help="reconstructed .sfm")
    p.add_argument("--features", required=True, help="features of the scene views")
    p.add_argument("--queryFolder", required=True, help="images to localize")
    p.add_argument("--output", required=True, help="poses .json")
    p.add_argument("--maxKeypoints", type=int, default=2048)
    p.add_argument("--downscaleTo", type=int, default=1024)
    p.add_argument("--method", default="voctree", choices=["voctree", "direct"],
                   help="voctree: retrieval-restricted matching "
                        "(VoctreeLocalizer.hpp); direct: landmark index")


def _camera_localization(args):
    """ref: src/software/pipeline/main_cameraLocalization.cpp,
    localization/VoctreeLocalizer.hpp:34-153: method=voctree retrieves the
    most similar database views and matches only their observations;
    method=direct matches the mean-descriptor landmark index. RANSAC draws
    from one generator seeded 0 on the device, across the queries. The
    seconds of each step, summed over the queries, go to stderr."""
    import time

    import numpy as np
    import torch

    from .. import sfmdata
    from ..localization import localize_image

    dev = args.dev
    sc = sfmdata.load(args.input)
    method = getattr(args, "method", "direct")
    if method == "voctree":
        from ..localization.voctree_localizer import VoctreeLocalizer

        vloc = VoctreeLocalizer(sc.points, sc.obs_landmark, sc.obs_view, _obs_descriptors(sc, args.features),
                                device=dev)
    else:
        lm_desc, lm_pts = _build_landmark_index_from_features(sc, args.features)
    fx = float(np.mean(sc.scale[:, 0]))
    w, h = float(sc.sizes[0, 0]), float(sc.sizes[0, 1])
    row = sc.intrinsics_table(device=dev).row(0)

    results = {}
    seconds = {"sift": 0.0}
    gen = torch.Generator(device=dev).manual_seed(0)
    for fname in _list_queries(args.queryFolder):
        t0 = time.perf_counter()
        desc, p = _query_features(os.path.join(args.queryFolder, fname), row, dev, args.maxKeypoints,
                                  args.downscaleTo)
        _sync(dev)
        seconds["sift"] += time.perf_counter() - t0
        if method == "voctree":
            res = vloc.localize(gen, desc, p, fx, (w, h), seconds=seconds)
        else:
            t0 = time.perf_counter()
            res = localize_image(gen, lm_desc, lm_pts, desc, p, fx, (w, h), device=dev)
            _sync(dev)
            seconds["matching_and_resection"] = seconds.get("matching_and_resection", 0.0) + time.perf_counter() - t0
        results[fname] = {
            "success": bool(res.success),
            "n_inliers": int(res.n_inliers),
            "R": np.asarray(res.R).tolist(),
            "c": np.asarray(res.c).tolist(),
        }
    print(f"[av] cameraLocalization seconds by step: {json.dumps(seconds)}", file=sys.stderr)
    _ensure_parent(args.output)
    with open(args.output, "w") as f:
        json.dump(results, f, indent=1)
    n_ok = sum(r["success"] for r in results.values())
    print(json.dumps({"localized": n_ok, "total": len(results)}))


command("cameraLocalization", _setup_camera_loc)(_camera_localization)


def _setup_rig_calib(p):
    p.add_argument("--inputs", required=True,
                   help="comma-separated posed .sfm, one per rig camera")
    p.add_argument("--output", required=True, help="rig .json")


def _rig_calibration(args):
    """ref: src/software/pipeline/main_rigCalibration.cpp, rig/Rig.cpp"""
    import numpy as np

    from .. import sfmdata
    from ..misc.rig import calibrate_rig

    scenes = [sfmdata.load(p) for p in args.inputs.split(",")]
    poses_per_cam = []
    frames = None
    for sc in scenes:
        fmap = {int(sc.view_frames[v]): v for v in sc.valid_views()}
        frames = sorted(fmap) if frames is None else [f for f in frames if f in fmap]
        poses_per_cam.append(fmap)
    if not frames:
        raise RuntimeError("no common frames across rig cameras")
    tracked = []
    for sc, fmap in zip(scenes, poses_per_cam):
        R = np.stack([sc.pose_R[sc.view_pose[fmap[f]]] for f in frames])
        c = np.stack([sc.pose_c[sc.view_pose[fmap[f]]] for f in frames])
        tracked.append((R, c))
    out = [{"R": np.asarray(R_rel).tolist(), "c": np.asarray(c_rel).tolist()}
           for R_rel, c_rel in calibrate_rig(tracked, device=args.dev)]
    _ensure_parent(args.output)
    with open(args.output, "w") as f:
        json.dump({"subposes": out, "frames": len(frames)}, f, indent=1)
    print(json.dumps({"cameras": len(out), "frames": len(frames)}))


command("rigCalibration", _setup_rig_calib)(_rig_calibration)


def _setup_rig_transform(p):
    p.add_argument("--input", required=True, help="rig-trajectory .sfm (cam 0)")
    p.add_argument("--rig", required=True, help="rig .json from rigCalibration")
    p.add_argument("--camera", type=int, required=True, help="sub-camera index")
    p.add_argument("--output", required=True)


def _rig_transform(args):
    """Apply a calibrated sub-pose to a rig trajectory
    (ref: src/software/utils/main_rigTransform.cpp)."""
    import numpy as np

    from .. import sfmdata

    sc = sfmdata.load(args.input)
    with open(args.rig) as f:
        sub = json.load(f)["subposes"][args.camera]
    R_rel = np.asarray(sub["R"])
    c_rel = np.asarray(sub["c"])
    for v in sc.valid_views():
        p = int(sc.view_pose[v])
        R0, c0 = sc.pose_R[p], sc.pose_c[p]
        # camera k's pose: the sub-pose composed with the rig (camera 0) pose
        # (both computed before R0, a view of the table, is overwritten)
        R, c = R_rel @ R0, c0 + R0.T @ c_rel
        sc.pose_R[p] = R
        sc.pose_c[p] = c
    sfmdata.save(sc, args.output)


command("rigTransform", _setup_rig_transform)(_rig_transform)


def _setup_rig_loc(p):
    p.add_argument("--input", required=True, help="reconstructed .sfm")
    p.add_argument("--features", required=True)
    p.add_argument("--queryFolders", required=True,
                   help="comma-separated folders, one per rig camera")
    p.add_argument("--rig", required=True, help="rig .json")
    p.add_argument("--output", required=True, help="rig poses .json")
    p.add_argument(
        "--fusion", default="joint", choices=["joint", "average"],
        help="joint = non-central resection over ALL rig cameras at once "
        "(rigResection.cpp); average = legacy per-camera + quaternion mean",
    )


def _rig_localization(args):
    """Localize the rig frame per query timestamp. --fusion joint: 2D-3D
    matches from every rig camera feed one joint non-central resection with
    the known sub-poses (ref: src/software/pipeline/main_rigLocalization.cpp,
    localization/rigResection.cpp, OpenGV's non-central PnP analog);
    --fusion average: per-camera cameraLocalization (direct) + a quaternion
    mean."""
    import numpy as np
    import torch

    from ..geometry import mat_to_quat, quat_to_mat
    from ..misc.rig import average_quaternions

    dev = args.dev
    with open(args.rig) as f:
        rig = json.load(f)
    folders = args.queryFolders.split(",")

    if getattr(args, "fusion", "joint") == "joint":
        from .. import sfmdata
        from ..localization.localizer import match_2d3d
        from ..localization.voctree_localizer import rig_resection

        sc = sfmdata.load(args.input)
        lm_desc, lm_pts = _build_landmark_index_from_features(sc, args.features)
        fx = float(np.mean(sc.scale[:, 0]))
        w, h = float(sc.sizes[0, 0]), float(sc.sizes[0, 1])
        row = sc.intrinsics_table(device=dev).row(0)
        # the sub-pose chain x_cam_k = sub_R x_frame + sub_t from the rig
        # json's (R_rel, c_rel) pose composition
        sub_R = np.stack([np.asarray(s["R"]) for s in rig["subposes"]])
        sub_t = np.stack([-np.asarray(s["R"]) @ np.asarray(s["c"]) for s in rig["subposes"]])
        names = sorted(set.intersection(*[set(_list_queries(f)) for f in folders]))
        fused = {}
        gen = torch.Generator(device=dev).manual_seed(0)
        for name in names:
            world_per_cam, obs_per_cam = [], []
            for folder in folders:
                desc, p = _query_features(os.path.join(folder, name), row, dev, 2048)
                wpts, onorm = match_2d3d(lm_desc, lm_pts, desc, p, device=dev)
                world_per_cam.append(wpts)
                obs_per_cam.append(onorm)
            res = rig_resection(gen, world_per_cam, obs_per_cam, sub_R, sub_t, fx, (w, h), device=dev)
            fused[name] = {
                "success": bool(res.success),
                "n_inliers": int(res.n_inliers),
                "R": np.asarray(res.R_frame).tolist(),
                "c": np.asarray(res.c_frame).tolist(),
            }
        _ensure_parent(args.output)
        with open(args.output, "w") as f:
            json.dump(fused, f, indent=1)
        print(json.dumps({"frames": len(fused), "fusion": "joint"}))
        return

    per_cam = []
    for k, folder in enumerate(folders):
        out_k = args.output + f".cam{k}.json"
        args2 = argparse.Namespace(input=args.input, features=args.features, queryFolder=folder, output=out_k,
                                   maxKeypoints=2048, downscaleTo=1024, dev=dev)
        _camera_localization(args2)
        with open(out_k) as f:
            per_cam.append(json.load(f))
    # fuse per matching filename
    names = sorted(set.intersection(*[set(p) for p in per_cam]))
    fused = {}
    for name in names:
        qs, cs = [], []
        for k, res in enumerate(per_cam):
            r = res[name]
            if not r["success"]:
                continue
            sub = rig["subposes"][k]
            R_rel, c_rel = np.asarray(sub["R"]), np.asarray(sub["c"])
            # the rig pose from camera k's pose
            R0 = R_rel.T @ np.asarray(r["R"])
            qs.append(R0)
            cs.append(np.asarray(r["c"]) - R0.T @ c_rel)
        if not qs:
            fused[name] = {"success": False}
            continue
        q = average_quaternions(mat_to_quat(torch.as_tensor(np.stack(qs), dtype=torch.float32, device=dev)))
        fused[name] = {
            "success": True,
            "R": quat_to_mat(q).cpu().numpy().tolist(),
            "c": np.mean(cs, axis=0).tolist(),
            "cameras": len(qs),
        }
    with open(args.output, "w") as f:
        json.dump(fused, f, indent=1)
    print(json.dumps({"frames": len(fused)}))


command("rigLocalization", _setup_rig_loc)(_rig_localization)


def _setup_sfm_to_rig(p):
    p.add_argument("--input", required=True, help="posed .sfm")
    p.add_argument("--output", required=True, help="rig .json")


def _sfm_to_rig(args):
    """Treat all posed views of a scene as one rig captured at a single
    instant: sub-poses relative to the first view
    (ref: src/software/utils/main_sfmToRig.cpp)."""
    from .. import sfmdata

    sc = sfmdata.load(args.input)
    valid = sc.valid_views()
    if len(valid) < 2:
        raise RuntimeError("need >= 2 posed views")
    p0 = int(sc.view_pose[valid[0]])
    R0, c0 = sc.pose_R[p0], sc.pose_c[p0]
    subposes = []
    for v in valid:
        p = int(sc.view_pose[v])
        Rk, ck = sc.pose_R[p], sc.pose_c[p]
        subposes.append({"viewId": int(sc.view_ids[v]), "R": (Rk @ R0.T).tolist(), "c": (R0 @ (ck - c0)).tolist()})
    _ensure_parent(args.output)
    with open(args.output, "w") as f:
        json.dump({"subposes": subposes}, f, indent=1)
    print(json.dumps({"cameras": len(subposes)}))


command("sfmToRig", _setup_sfm_to_rig)(_sfm_to_rig)


def _setup_pano_prepare(p):
    p.add_argument("--inputFolder", required=True)
    p.add_argument("--output", required=True, help="output folder")
    p.add_argument("--downscaleTo", type=int, default=0)


@command("panoramaPrepareImages", _setup_pano_prepare)
def _panorama_prepare_images(args):
    """Normalize orientation/size of panorama inputs, on the host
    (ref: src/software/pipeline/main_panoramaPrepareImages.cpp)."""
    import numpy as np

    from ..image.io import read_exif, read_image, write_image

    files = sorted(f for f in os.listdir(args.inputFolder) if f.lower().endswith((".jpg", ".png", ".jpeg", ".npy")))
    os.makedirs(args.output, exist_ok=True)
    for fname in files:
        img = read_image(os.path.join(args.inputFolder, fname))
        rot = int(read_exif(os.path.join(args.inputFolder, fname)).get("orientation", 1))
        if rot in (3, 6, 8):
            img = np.rot90(img, {3: 2, 6: 3, 8: 1}[rot])
        if args.downscaleTo and max(img.shape[:2]) > args.downscaleTo:
            s = max(img.shape[:2]) // args.downscaleTo + 1
            img = img[::s, ::s]
        write_image(os.path.join(args.output, os.path.splitext(fname)[0] + ".png"), img)
    print(json.dumps({"images": len(files)}))


def _setup_pano_init(p):
    p.add_argument("--imageFolder", required=True)
    p.add_argument("--output", required=True, help=".sfm with yaw-init poses")
    p.add_argument("--fisheye", action="store_true")
    p.add_argument("--defaultFocalPx", type=float, default=None)
    p.add_argument("--nbViewsPerRow", type=int, default=0,
                   help="0 = single ring; else rows x cols rig pattern")


@command("panoramaInit", _setup_pano_init)
def _panorama_init(args):
    """Initial rotations for a panorama shoot: evenly spaced yaw (and pitch
    rows for multi-row rigs) (ref: src/software/pipeline/main_panoramaInit.cpp)."""
    import numpy as np

    from .. import camera as camm
    from .. import sfmdata
    from .stages import camera_init

    tmp = args.output + ".init.sfm"
    camera_init(args.imageFolder, tmp, None, args.defaultFocalPx, device=args.dev)
    sc = sfmdata.load(tmp)
    os.remove(tmp)
    if args.fisheye:
        sc.cam_kind[:] = camm.CAM_EQUIDISTANT
    n = sc.n_views
    per_row = args.nbViewsPerRow or n
    rows = max(1, (n + per_row - 1) // per_row)
    for v in range(n):
        row_i, col_i = divmod(v, per_row)
        yaw = 2.0 * np.pi * col_i / per_row
        pitch = 0.0 if rows == 1 else (row_i / max(rows - 1, 1) - 0.5) * np.pi / 2
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Ry = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]])
        Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        sc.set_pose(v, Rx @ Ry, np.zeros(3))
    sfmdata.save(sc, args.output)
    print(json.dumps({"views": n, "rows": rows}))


def _setup_pano_seams(p):
    p.add_argument("--input", required=True, help="warped folder")
    p.add_argument("--output", required=True, help="labels .npy")


@command("panoramaSeams", _setup_pano_seams)
def _panorama_seams(args):
    """ref: src/software/pipeline/main_panoramaSeams.cpp, panorama/seams.cpp"""
    import numpy as np
    import torch

    from ..panorama.compositing import seam_labels

    masks, order = [], []
    for f in sorted(os.listdir(args.input)):
        if f.endswith("_mask.npy"):
            masks.append(np.load(os.path.join(args.input, f)))
            order.append(f.replace("_mask.npy", ""))
    if not masks:
        raise RuntimeError("no *_mask.npy in input folder")
    labels = seam_labels(torch.as_tensor(np.stack(masks), device=args.dev))
    _ensure_parent(args.output)
    np.savez_compressed(args.output, labels=labels.cpu().numpy(), views=np.asarray(order))
    print(json.dumps({"views": len(masks)}))


def _setup_pano_merge(p):
    p.add_argument("--input", required=True, help="warped folder")
    p.add_argument("--seams", default=None, help="labels .npz from panoramaSeams")
    p.add_argument("--output", required=True, help="panorama image")
    p.add_argument("--levels", type=int, default=5)


@command("panoramaMerging", _setup_pano_merge)
def _panorama_merging(args):
    """Blend warped views into the final panorama, optionally with
    precomputed seams (ref: src/software/pipeline/main_panoramaMerging.cpp)."""
    import numpy as np
    import torch

    from ..image.io import write_image
    from ..panorama.compositing import composite_panorama, composite_with_labels
    from .cli import load_warped

    w, m = load_warped(args.input, args.dev)
    if args.seams:
        with np.load(args.seams) as z:
            labels = torch.as_tensor(z["labels"], device=args.dev)
        pano = composite_with_labels(w, labels, m, levels=args.levels)
    else:
        pano = composite_panorama(w, m, levels=args.levels)
    _ensure_parent(args.output)
    write_image(args.output, pano.cpu().numpy())


def _setup_pano_post(p):
    p.add_argument("--input", required=True, help="panorama image")
    p.add_argument("--output", required=True)
    p.add_argument("--fillHoles", action="store_true")
    p.add_argument("--crop", action="store_true")


@command("panoramaPostProcessing", _setup_pano_post)
def _panorama_post_processing(args):
    """ref: src/software/pipeline/main_panoramaPostProcessing.cpp"""
    import numpy as np
    import torch

    from ..image.io import read_image, write_image
    from ..panorama.compositing import crop_to_content, fill_holes

    img = read_image(args.input, grayscale=True)
    mask = img > 0
    out = img
    if args.fillHoles:
        out = fill_holes(torch.as_tensor(img, device=args.dev), torch.as_tensor(mask, device=args.dev))
        out = out.cpu().numpy()
        mask = np.ones_like(mask)
    if args.crop:
        out, mask, _ = crop_to_content(out, mask)
    write_image(args.output, np.asarray(out))


def _setup_cc_detect(p):
    p.add_argument("--input", required=True, help="image or folder")
    p.add_argument("--output", required=True, help="detections .json")


def _color_checker_detection(args):
    """ref: src/software/utils/main_colorCheckerDetection.cpp"""
    import numpy as np

    from ..image.io import read_image
    from ..misc.color_checker import detect_color_checker

    files = _folder_or_file(args.input)
    out = {}
    for path in files:
        img = read_image(path)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        det = detect_color_checker(img)
        if det is not None:
            centers, colors = det
            out[os.path.basename(path)] = {"positions": np.asarray(centers).tolist(),
                                           "colors": np.asarray(colors).tolist()}
    _ensure_parent(args.output)
    with open(args.output, "w") as f:
        json.dump({"checkers": out}, f)
    print(json.dumps({"detected": len(out)}))


command("colorCheckerDetection", _setup_cc_detect)(_color_checker_detection)


def _setup_cc_correct(p):
    p.add_argument("--input", required=True, help="image or folder")
    p.add_argument("--detections", required=True, help="from colorCheckerDetection")
    p.add_argument("--output", required=True, help="image or folder")


def _color_checker_correction(args):
    """ref: src/software/utils/main_colorCheckerCorrection.cpp"""
    import numpy as np

    from ..image.io import read_image, write_image
    from ..misc.color_checker import apply_color_correction, color_correction_matrix

    with open(args.detections) as f:
        det = json.load(f)["checkers"]
    if not det:
        raise RuntimeError("no checker detections")
    M = color_correction_matrix(np.asarray(next(iter(det.values()))["colors"]))
    if os.path.isdir(args.input):
        os.makedirs(args.output, exist_ok=True)
        pairs = [(os.path.join(args.input, f), os.path.join(args.output, f)) for f in _list_queries(args.input)]
    else:
        pairs = [(args.input, args.output)]
    for src, dst in pairs:
        img = read_image(src)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        write_image(dst, np.clip(apply_color_correction(img, M), 0, 1))
    print(json.dumps({"images": len(pairs)}))


command("colorCheckerCorrection", _setup_cc_correct)(_color_checker_correction)


def _setup_export_mvstex(p):
    p.add_argument("--input", required=True, help="posed .sfm")
    p.add_argument("--output", required=True, help="output folder")


@command("exportMVSTexturing", _setup_export_mvstex)
def _export_mvs_texturing(args):
    """MVS-Texturing (mvs-tex) camera format: one .cam per view
    ('tx ty tz R00..R22' / 'f d0 d1 paspect ppx ppy', normalized)
    (ref: src/software/export/main_exportMVSTexturing.cpp)."""
    from .. import sfmdata

    sc = sfmdata.load(args.input)
    os.makedirs(args.output, exist_ok=True)
    n = 0
    for v in sc.valid_views():
        K, R, c = sc.camera_matrices(v)
        t = -R @ c
        w, h = int(sc.view_sizes[v, 0]), int(sc.view_sizes[v, 1])
        f_norm = K[0, 0] / max(w, h)
        ppx, ppy = K[0, 2] / w, K[1, 2] / h
        paspect = K[1, 1] / K[0, 0]
        path = os.path.join(args.output, f"{int(sc.view_ids[v])}.cam")
        with open(path, "w") as fo:
            fo.write(f"{t[0]} {t[1]} {t[2]} " + " ".join(str(x) for x in R.reshape(-1)) + "\n")
            fo.write(f"{f_norm} 0 0 {paspect} {ppx} {ppy}\n")
        n += 1
    print(json.dumps({"cameras": n}))


def _setup_export_matlab(p):
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True, help="output folder")


@command("exportMatlab", _setup_export_matlab)
def _export_matlab(args):
    """Per-view K/R/t text files loadable from Matlab/Octave
    (ref: src/software/export/main_exportMatlab.cpp)."""
    from .. import sfmdata

    sc = sfmdata.load(args.input)
    os.makedirs(args.output, exist_ok=True)
    n = 0
    for v in sc.valid_views():
        K, R, c = sc.camera_matrices(v)
        t = -R @ c
        vid = int(sc.view_ids[v])
        for name, arr in (("K", K), ("R", R), ("t", t.reshape(1, 3))):
            with open(os.path.join(args.output, f"{vid}_{name}.txt"), "w") as fo:
                for row in arr:
                    fo.write(" ".join(f"{x:.12g}" for x in row) + "\n")
        n += 1
    # one loader script
    with open(os.path.join(args.output, "load_scene.m"), "w") as fo:
        fo.write("% per-view K/R/t text files; t = -R*c (world->cam)\n")
    print(json.dumps({"cameras": n}))


def _setup_export_mmaya(p):
    p.add_argument("--input", required=True, help="reconstructed .sfm")
    p.add_argument("--output", required=True, help="output folder")
    p.add_argument("--images", default=None, help="undistorted images folder")


@command("exportMeshroomMaya", _setup_export_mmaya)
def _export_meshroom_maya(args):
    """MeshroomMaya project folder: native-Alembic scene + point cloud +
    per-view cameras + image list
    (ref: src/software/export/main_exportMeshroomMaya.cpp)."""
    import shutil

    from .. import sfmdata

    sc = sfmdata.load(args.input)
    os.makedirs(args.output, exist_ok=True)
    sfmdata.save(sc, os.path.join(args.output, "scene.abc"))
    sfmdata.save_ply(sc, os.path.join(args.output, "pointCloud.ply"))
    cams = {}
    for v in sc.valid_views():
        K, R, c = sc.camera_matrices(v)
        cams[int(sc.view_ids[v])] = {
            "K": K.tolist(), "R": R.tolist(), "c": c.tolist(),
            "image": os.path.basename(sc.view_paths[v] or ""),
            "size": [int(x) for x in sc.view_sizes[v]],
        }
    with open(os.path.join(args.output, "cameras.json"), "w") as f:
        json.dump(cams, f, indent=1)
    if args.images and os.path.isdir(args.images):
        dst = os.path.join(args.output, "undistorted")
        os.makedirs(dst, exist_ok=True)
        for fname in os.listdir(args.images):
            shutil.copy(os.path.join(args.images, fname), dst)
    print(json.dumps({"cameras": len(cams)}))
