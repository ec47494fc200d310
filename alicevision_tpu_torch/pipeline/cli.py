"""`av-torch` — the port's CLI, one subcommand per pipeline stage.

Port of `alicevision_tpu/pipeline/cli.py` (the counterpart of the
reference's per-stage executables, ref: SURVEY.md §2.7,
src/aliceVision/cmdline/cmdline.cpp:13-26 shared flags): the same
subcommands with the same flags, defaults and file contracts, so that an
orchestrator drives it as Meshroom drives the reference, one process per
stage talking through files. Every subcommand also takes `--device`
(default `cuda`): without a CUDA device a command fails unless it is given
`--device cpu`. All 103 subcommands of the JAX CLI run.

Usage examples:
  python -m alicevision_tpu_torch.pipeline.cli cameraInit --imageFolder imgs/ --output scene.sfm
  av-torch featureExtraction --input scene.sfm --output feats/
  av-torch imageMatching --input scene.sfm --features feats/ --output pairs.txt
  av-torch featureMatching --input scene.sfm --features feats/ \
      --pairs pairs.txt --output matches.npz
  av-torch incrementalSfm --input scene.sfm --features feats/ \
      --matches matches.npz --output sfm.sfm
  av-torch prepareDenseScene --input sfm.sfm --output dense/
  av-torch depthMapEstimation --input sfm.sfm --images dense/ --output depth/
  av-torch depthMapFiltering --input sfm.sfm --depth depth/ --output depthf/
  av-torch meshSurface --input sfm.sfm --depth depthf/ --output mesh.obj
  av-torch meshFiltering --input mesh.obj --output filtered.obj --clean
  av-torch texturing --input sfm.sfm --mesh filtered.obj --images dense/ --output textured.obj
  av-torch pipeline --imageFolder imgs/ --output work/     # run everything
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def _add_common(p):
    p.add_argument("--verboseLevel", default="info", help="log level")
    p.add_argument("--rangeStart", type=int, default=0)
    p.add_argument("--rangeSize", type=int, default=-1)
    p.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="capture a torch.profiler trace of this stage into DIR as a "
        "Chrome trace (view with Perfetto) — the analog of the reference's "
        "NVTX ranges (ref: system/nvtx.hpp)",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device the stage computes on; without a CUDA "
                        "device the command fails unless it is 'cpu'")


def build_parser() -> argparse.ArgumentParser:
    """The reference CLI's parser (`alicevision_tpu/pipeline/cli.py::
    build_parser`): every subcommand with its flags and defaults, and
    `--device` on each."""
    ap = argparse.ArgumentParser(prog="av-torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("cameraInit")
    p.add_argument("--imageFolder", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--sensorDatabase", default=None)
    p.add_argument("--defaultFocalPx", type=float, default=None)
    _add_common(p)

    p = sub.add_parser("featureExtraction")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--maxKeypoints", type=int, default=4096)
    p.add_argument("--dsp", action="store_true")
    p.add_argument("--downscaleTo", type=int, default=1024)
    p.add_argument("--describerTypes", default="dspsift",
                   help="comma list: sift,tag16h5,cctag3")
    _add_common(p)

    p = sub.add_parser("imageMatching")
    p.add_argument("--input", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--method", default="exhaustive",
                   choices=["exhaustive", "voctree", "sequential"])
    p.add_argument("--nbNeighbors", type=int, default=10)
    _add_common(p)

    p = sub.add_parser("featureMatching")
    p.add_argument("--input", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--pairs", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--ratio", type=float, default=0.8)
    p.add_argument("--geometric", default="fundamental",
                   choices=["fundamental", "homography_growing", "none"])
    _add_common(p)

    p = sub.add_parser("incrementalSfm")
    p.add_argument("--input", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--matches", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--minTrackLength", type=int, default=2)
    _add_common(p)

    p = sub.add_parser("tracksBuilding")
    p.add_argument("--input", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--matches", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--minTrackLength", type=int, default=2)
    _add_common(p)

    p = sub.add_parser("sfmBootstraping")
    p.add_argument("--input", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--tracks", required=True)
    p.add_argument("--output", required=True)
    _add_common(p)

    p = sub.add_parser("sfmExpanding")
    p.add_argument("--input", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--tracks", required=True)
    p.add_argument("--output", required=True)
    _add_common(p)

    p = sub.add_parser("prepareDenseScene")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    _add_common(p)

    p = sub.add_parser("depthMapEstimation")
    p.add_argument("--input", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--nbDepths", type=int, default=96)
    p.add_argument("--nbTCams", type=int, default=4)
    p.add_argument("--downscale", type=int, default=2)
    p.add_argument("--refine", action="store_true",
                   help="run the Refine pass (offset volume + color opt)")
    _add_common(p)

    p = sub.add_parser("depthMapFiltering")
    p.add_argument("--input", required=True)
    p.add_argument("--depth", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--minConsistent", type=int, default=3)
    p.add_argument("--downscale", type=int, default=2)
    p.add_argument("--computeNormalMaps", action="store_true",
                   help="write per-view normal maps from the filtered depths")
    p.add_argument("--nNearestCams", type=int, default=0,
                   help="bound the consistency set to +-k ring neighbours "
                        "(0 = all views; ref maxNbNearestCams)")
    _add_common(p)

    p = sub.add_parser("meshing")
    p.add_argument("--input", required=True)
    p.add_argument("--depth", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--voxelSize", type=float, default=0.0)
    p.add_argument("--downscale", type=int, default=2)
    _add_common(p)

    p = sub.add_parser("meshSurface")
    p.add_argument("--input", required=True)
    p.add_argument("--depth", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--images", default=None, help="undistorted images for color bake")
    p.add_argument("--voxelSize", type=float, default=0.0)
    p.add_argument("--downscale", type=int, default=2)
    p.add_argument("--maxPoints", type=int, default=50000)
    _add_common(p)

    p = sub.add_parser("meshFiltering")
    p.add_argument("--input", required=True, help="input .obj")
    p.add_argument("--output", required=True)
    p.add_argument("--smoothIters", type=int, default=5)
    p.add_argument("--keepRatio", type=float, default=0.0)
    p.add_argument("--clean", action="store_true",
                   help="manifold repair (MeshClean): degenerate/duplicate "
                        "faces, non-manifold edges, bowtie vertices")
    p.add_argument("--fillHolesMaxEdges", type=int, default=0,
                   help="fan-fill boundary loops up to this many edges")
    _add_common(p)

    p = sub.add_parser("meshDecimate")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--cellSize", type=float, default=None, help="grid clustering cell")
    p.add_argument("--targetFaces", type=int, default=None, help="QEM decimation target")
    _add_common(p)

    p = sub.add_parser("meshDenoising")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--iterations", type=int, default=8)
    p.add_argument("--sigmaNormal", type=float, default=0.35)
    _add_common(p)

    p = sub.add_parser("meshResampling")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--targetEdge", type=float, required=True)
    _add_common(p)

    p = sub.add_parser("meshMasking")
    p.add_argument("--input", required=True, help="posed .sfm")
    p.add_argument("--mesh", required=True)
    p.add_argument("--masks", required=True, help="folder of <viewId>.png masks")
    p.add_argument("--output", required=True)
    p.add_argument("--minViews", type=int, default=1)
    p.add_argument("--invert", action="store_true")
    _add_common(p)

    p = sub.add_parser("texturing")
    p.add_argument("--input", required=True, help="reconstructed .sfm")
    p.add_argument("--mesh", required=True, help="input .obj")
    p.add_argument("--images", required=True, help="undistorted image folder")
    p.add_argument("--depth", default=None, help="depth folder for occlusion")
    p.add_argument("--output", required=True, help="textured .obj")
    p.add_argument("--atlasSize", type=int, default=2048)
    p.add_argument("--downscale", type=int, default=2)
    p.add_argument("--useScore", dest="multiband", action="store_true", default=True,
                   help="multi-band top-K view fusion (reference default)")
    p.add_argument("--noMultiband", dest="multiband", action="store_false")
    p.add_argument("--multiBandNbContrib", type=int, default=4,
                   help="views fused per face (ref: Texturing.hpp multiBandNbContrib)")
    p.add_argument("--multiBandDownscale", type=int, default=4,
                   help="pyramid levels for the multi-band blend")
    p.add_argument("--denseMesh", default=None,
                   help="dense .obj to bake normal/height maps from "
                        "(ref: Texturing bump/normal map baking)")
    _add_common(p)

    p = sub.add_parser("panoramaEstimation")
    p.add_argument("--input", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--matches", required=True)
    p.add_argument("--output", required=True)
    _add_common(p)

    p = sub.add_parser("panoramaWarping")
    p.add_argument("--input", required=True, help=".sfm with rotation poses")
    p.add_argument("--output", required=True, help="warped folder")
    p.add_argument("--panoWidth", type=int, default=2048)
    _add_common(p)

    p = sub.add_parser("panoramaCompositing")
    p.add_argument("--input", required=True, help="warped folder")
    p.add_argument("--output", required=True, help="panorama image")
    _add_common(p)

    p = sub.add_parser("convertSfMFormat")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    _add_common(p)

    p = sub.add_parser("exportMeshlab")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--mesh", default=None)
    _add_common(p)

    p = sub.add_parser("exportAnimatedCamera")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--fps", type=float, default=24.0)
    _add_common(p)

    p = sub.add_parser("importKnownPoses")
    p.add_argument("--input", required=True)
    p.add_argument("--poses", required=True)
    p.add_argument("--output", required=True)
    _add_common(p)

    p = sub.add_parser("hardwareResources")
    _add_common(p)

    p = sub.add_parser("pipeline")
    p.add_argument("--imageFolder", required=True)
    p.add_argument("--output", required=True, help="working folder")
    p.add_argument("--method", default="exhaustive")
    p.add_argument("--maxKeypoints", type=int, default=4096)
    p.add_argument("--skipMvs", action="store_true")
    p.add_argument("--defaultFocalPx", type=float, default=None)
    _add_common(p)

    # ---- utils / convert / export stages --------------------------------
    p = sub.add_parser("sfmTransform")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument(
        "--method",
        default="auto",
        choices=["auto", "from_poses", "from_gps", "from_markers"],
    )
    p.add_argument("--reference", default=None, help=".sfm to align onto")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument(
        "--gpsFile",
        default=None,
        help="JSON {viewId: [lat_deg, lon_deg, alt_m]} for from_gps",
    )
    p.add_argument(
        "--markersFile",
        default=None,
        help="JSON {markerId: [x, y, z]} for from_markers",
    )
    _add_common(p)

    p = sub.add_parser("qualityEvaluation")
    p.add_argument("--input", required=True)
    p.add_argument("--groundTruth", required=True)
    _add_common(p)

    p = sub.add_parser("exportColmap")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    _add_common(p)

    p = sub.add_parser("exportMVE2")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    _add_common(p)

    p = sub.add_parser("exportPMVS")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    _add_common(p)

    p = sub.add_parser("exportUSD")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True, help=".usda path")
    p.add_argument("--mesh", default=None, help="optional .obj to embed")
    _add_common(p)

    p = sub.add_parser("convertMesh")
    p.add_argument("--input", required=True, help=".obj or .ply mesh")
    p.add_argument("--output", required=True, help=".obj or .ply mesh")
    _add_common(p)

    p = sub.add_parser("sfmStatistics")
    p.add_argument("--input", required=True)
    p.add_argument("--output", default=None, help="HTML report path")
    _add_common(p)

    p = sub.add_parser("split360Images")
    p.add_argument("--input", required=True, help="equirect image")
    p.add_argument("--output", required=True, help="output folder")
    p.add_argument("--nbSplits", type=int, default=8)
    p.add_argument("--fov", type=float, default=90.0)
    p.add_argument("--outSize", type=int, default=1024)
    _add_common(p)

    p = sub.add_parser("imageProcessing")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--sharpen", type=float, default=0.0)
    p.add_argument("--contrast", type=float, default=1.0)
    p.add_argument("--denoise", action="store_true")
    p.add_argument("--lcp", default=None, help="Adobe LCP profile (.lcp)")
    p.add_argument("--focalMm", type=float, default=0.0,
                   help="focal length for LCP alternate selection")
    p.add_argument("--lensCorrection", default="geometry,vignetting",
                   help="comma list applied when --lcp is set")
    p.add_argument("--dcp", default=None, help="DNG camera profile (.dcp XML)")
    p.add_argument("--cct", type=float, default=5000.0,
                   help="correlated color temperature for DCP interpolation")
    p.add_argument("--inputColorSpace", default="auto",
                   help="srgb|linear|rec709|aces2065-1|acescg|xyz|lab|auto")
    p.add_argument("--outputColorSpace", default="auto",
                   help="srgb|linear|rec709|aces2065-1|acescg|xyz|lab|auto")
    _add_common(p)

    p = sub.add_parser("imageSegmentation")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True, help="mask png")
    p.add_argument("--threshold", type=float, default=0.35)
    p.add_argument("--modelPath", default=None,
                   help=".onnx segmentation model (runs through "
                        "onnxruntime when importable, else the built-in "
                        "native executor); default: classical sky scorer")
    _add_common(p)

    p = sub.add_parser("keyframeSelection")
    p.add_argument("--inputFolder", required=True, help="frame folder")
    p.add_argument("--output", required=True, help="selected list file")
    p.add_argument("--method", default="smart", choices=["smart", "regular"])
    p.add_argument("--step", type=int, default=10)
    _add_common(p)

    p = sub.add_parser("ldrToHdrSampling")
    p.add_argument("--inputFolder", required=True)
    p.add_argument("--output", required=True, help="samples .npz")
    p.add_argument("--nbBrackets", type=int, default=3)
    p.add_argument("--samples", type=int, default=800)
    _add_common(p)

    p = sub.add_parser("ldrToHdrCalibration")
    p.add_argument("--input", required=True, help="samples .npz from ldrToHdrSampling")
    p.add_argument("--output", required=True, help="response .npz")
    p.add_argument(
        "--calibrationMethod",
        choices=["laguerre", "grossberg", "debevec"],
        default="laguerre",
    )
    _add_common(p)

    p = sub.add_parser("ldrToHdrMerge")
    p.add_argument("--inputFolder", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--nbBrackets", type=int, default=3)
    p.add_argument("--response", default=None, help="response .npz from ldrToHdrCalibration")
    _add_common(p)

    p = sub.add_parser("lidarMerging")
    p.add_argument("--input", required=True, help="input-set JSON")
    p.add_argument("--output", required=True, help="merged .ply")
    p.add_argument("--outputOrigins", default=None, help="per-point origins .npy")
    _add_common(p)

    p = sub.add_parser("lidarDecimating")
    p.add_argument("--input", required=True, help="merged .ply")
    p.add_argument("--origins", default=None, help="origins .npy from lidarMerging")
    p.add_argument("--output", required=True, help="decimated .ply")
    p.add_argument("--outputOrigins", default=None)
    p.add_argument("--cellSize", type=float, required=True)
    _add_common(p)

    p = sub.add_parser("lidarMeshing")
    p.add_argument("--input", required=True, help=".ply cloud or input-set JSON")
    p.add_argument("--origins", default=None, help="origins .npy (for .ply input)")
    p.add_argument("--output", required=True, help="mesh .obj")
    p.add_argument("--maxPoints", type=int, default=50000)
    _add_common(p)

    p = sub.add_parser("importE57")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    _add_common(p)

    p = sub.add_parser("voctreeCreation")
    p.add_argument("--features", required=True, help="feature folder")
    p.add_argument("--input", required=True, help=".sfm with the views")
    p.add_argument("--output", required=True, help="tree npz")
    p.add_argument("--branching", type=int, default=8)
    p.add_argument("--levels", type=int, default=3)
    _add_common(p)

    p = sub.add_parser("computeUncertainty")
    p.add_argument("--input", required=True, help="reconstructed .sfm")
    p.add_argument("--output", required=True, help="covariances npz")
    _add_common(p)

    p = sub.add_parser("nodalSfM")
    p.add_argument("--input", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--matches", required=True)
    p.add_argument("--output", required=True)
    _add_common(p)

    p = sub.add_parser("checkerboardCalibration")
    p.add_argument("--inputFolder", required=True)
    p.add_argument("--output", required=True, help="calibration json")
    p.add_argument("--rows", type=int, required=True)
    p.add_argument("--cols", type=int, required=True)
    _add_common(p)


    # the long tail of reference tools lives in the cli_ext registry
    from . import cli_ext

    cli_ext.register(sub, _add_common)

    return ap


def main(argv=None) -> int:
    """CLI entry. Like the reference's aliceVision_main wrapper
    (ref: system/main.hpp:33-48), every exception is caught, logged as a
    fatal error, and turned into a non-zero exit code."""
    try:
        return _dispatch(argv)
    except SystemExit:
        raise
    except Exception as exc:  # noqa: BLE001 — the top-level catch IS the contract
        print(f"[av] fatal: {exc}", file=sys.stderr)
        return 1


def _profiler(prof_dir, dev):
    """A torch.profiler context that writes a Chrome trace into prof_dir
    on exit, or a null context."""
    if not prof_dir:
        return contextlib.nullcontext()
    import torch

    os.makedirs(prof_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def done(prof):
        prof.export_chrome_trace(os.path.join(prof_dir, f"trace_{os.getpid()}.json"))

    return torch.profiler.profile(activities=acts, on_trace_ready=done)


def _dispatch(argv=None) -> int:
    import torch

    from ..device import resolve_device

    args = build_parser().parse_args(argv)
    args.dev = resolve_device(args.device)
    handler = getattr(args, "_handler", None) or _HANDLERS[args.cmd]
    t0 = time.time()
    with _profiler(args.profile, args.dev):
        handler(args)
    msg = f"[av] {args.cmd} done in {time.time() - t0:.1f}s"
    if args.dev.type == "cuda":
        msg += f", peak device memory {torch.cuda.max_memory_allocated(args.dev) / 2**30:.3f} GiB"
    print(msg, file=sys.stderr)
    return 0


# ---------------------------------------------------------------------------
# handlers of the reference cli.py's subcommands
# ---------------------------------------------------------------------------


def _camera_init(args):
    from . import stages

    stages.camera_init(args.imageFolder, args.output, args.sensorDatabase, args.defaultFocalPx,
                       device=args.dev)


def _feature_extraction(args):
    from . import stages

    stages.feature_extraction(
        args.input, args.output, args.maxKeypoints, args.dsp, args.rangeStart, args.rangeSize,
        args.downscaleTo, describer_types=args.describerTypes, device=args.dev,
    )


def _image_matching(args):
    from . import stages

    stages.image_matching(args.input, args.features, args.output, args.method, args.nbNeighbors,
                          device=args.dev)


def _feature_matching(args):
    from . import stages

    stages.feature_matching(
        args.input, args.features, args.pairs, args.output, args.ratio, args.geometric,
        range_start=args.rangeStart, range_size=args.rangeSize, device=args.dev,
    )


def _incremental_sfm(args):
    from . import stages

    stages.incremental_sfm(args.input, args.features, args.matches, args.output, args.minTrackLength,
                           device=args.dev)


def _tracks_building(args):
    from . import stages

    stages.tracks_building(args.input, args.features, args.matches, args.output, args.minTrackLength,
                           device=args.dev)


def _sfm_bootstrapping(args):
    from . import stages

    stages.sfm_bootstrapping(args.input, args.features, args.tracks, args.output, device=args.dev)


def _sfm_expanding(args):
    from . import stages

    stages.sfm_expanding(args.input, args.features, args.tracks, args.output, device=args.dev)


def _prepare_dense_scene(args):
    from . import stages

    stages.prepare_dense_scene(args.input, args.output, device=args.dev)


def _depth_map_estimation(args):
    from . import stages

    stages.depth_map_estimation(
        args.input, args.images, args.output, args.nbDepths, args.nbTCams, args.downscale,
        args.rangeStart, args.rangeSize, refine=args.refine, device=args.dev,
    )


def _depth_map_filtering(args):
    from . import stages

    stages.depth_map_filtering(
        args.input, args.depth, args.output, args.minConsistent, args.downscale,
        compute_normal_maps=args.computeNormalMaps, n_nearest_cams=args.nNearestCams, device=args.dev,
    )


def _meshing(args):
    from . import stages

    stages.meshing_point_cloud(args.input, args.depth, args.output, args.voxelSize, args.downscale,
                               device=args.dev)


def _mesh_surface(args):
    from . import stages

    stages.meshing_surface(
        args.input, args.depth, args.output, args.voxelSize, args.downscale, args.maxPoints,
        images_folder=args.images, device=args.dev,
    )


def _mesh_filtering(args):
    import torch

    from ..mesh import clean_mesh, laplacian_smooth, largest_component, load_obj, save_obj

    v, f = load_obj(args.input)
    if args.clean or args.fillHolesMaxEdges > 2:
        v, f = clean_mesh(v, f, fill_holes_max_edges=args.fillHolesMaxEdges)
    v, f = largest_component(v, f, keep_ratio=args.keepRatio)
    x = torch.as_tensor(v, dtype=torch.float32, device=args.dev)
    save_obj(args.output, laplacian_smooth(x, f, iterations=args.smoothIters).cpu().numpy(), f)


def _mesh_decimate(args):
    from ..mesh import decimate_grid, decimate_qem, load_obj, save_obj

    v, f = load_obj(args.input)
    if args.targetFaces is not None:
        v, f = decimate_qem(v, f, args.targetFaces)
    elif args.cellSize is not None:
        v, f = decimate_grid(v, f, args.cellSize)
    else:
        raise SystemExit("meshDecimate: give --targetFaces (QEM) or --cellSize (grid)")
    save_obj(args.output, v, f)


def _mesh_denoising(args):
    from ..mesh import denoise_sd, load_obj, save_obj

    v, f = load_obj(args.input)
    v = denoise_sd(v, f, iterations=args.iterations, sigma_n=args.sigmaNormal, device=args.dev)
    save_obj(args.output, v, f)


def _mesh_resampling(args):
    from ..mesh import load_obj, resample, save_obj

    v, f = load_obj(args.input)
    save_obj(args.output, *resample(v, f, target_edge=args.targetEdge, device=args.dev))


def _mesh_masking(args):
    import numpy as np

    from .. import sfmdata
    from ..image.io import read_image
    from ..mesh import load_obj, mask_faces_by_views, save_obj

    sc = sfmdata.load(args.input)
    v, f = load_obj(args.mesh)
    projs, masks = [], []
    for vidx in sc.valid_views():
        path = os.path.join(args.masks, f"{int(sc.view_ids[vidx])}.png")
        if not os.path.exists(path):
            continue
        m = read_image(path)
        if m.ndim == 3:
            m = m[..., 0]
        masks.append(m > 0.5)
        K, R, c = sc.camera_matrices(vidx)

        def proj(X, K=K, R=R, c=c):
            Xc = (X - c) @ R.T
            uvh = Xc @ K.T
            return uvh[:, :2] / np.maximum(uvh[:, 2:], 1e-9), Xc[:, 2]

        projs.append(proj)
    v, f = mask_faces_by_views(v, f, projs, masks, min_views=args.minViews, invert=args.invert)
    save_obj(args.output, v, f)


def _texturing(args):
    import numpy as np

    from .. import sfmdata
    from ..image.io import read_image
    from ..mesh import load_obj
    from ..mesh.uv_atlas import generate_textured_mesh

    sc = sfmdata.load(args.input)
    V, F = load_obj(args.mesh)
    imgs, Ks, Rs, cs, dms = [], [], [], [], []
    ds = args.downscale
    for v in sc.valid_views():
        vid = int(sc.view_ids[v])
        path = os.path.join(args.images, f"{vid}.npy")
        if not os.path.exists(path):
            continue
        img = read_image(path, grayscale=True)
        imgs.append(img[::ds, ::ds] if ds > 1 else img)
        ii = int(sc.view_intrinsic[v])
        fx, fy = sc.scale[ii] / ds
        pp = (sc.offset[ii] + 0.5 * sc.sizes[ii]) / ds
        Ks.append(np.array([[fx, 0, pp[0]], [0, fy, pp[1]], [0, 0, 1.0]]))
        p = int(sc.view_pose[v])
        Rs.append(sc.pose_R[p])
        cs.append(sc.pose_c[p])
        dpath = os.path.join(args.depth, f"{vid}_depth.npy") if args.depth else None
        dms.append(np.load(dpath) if dpath and os.path.exists(dpath) else None)
    dense = load_obj(args.denseMesh) if args.denseMesh else None
    seconds: dict = {}
    generate_textured_mesh(
        V, F, imgs, np.stack(Ks), np.stack(Rs), np.stack(cs), args.output,
        depth_maps=dms if args.depth else None, atlas_size=args.atlasSize,
        multiband=args.multiband, top_k=args.multiBandNbContrib,
        levels=args.multiBandDownscale, bake_from_dense=dense, device=args.dev, seconds=seconds,
    )
    print(json.dumps({"texturing_seconds": seconds}))


def _convert_sfm_format(args):
    from .. import sfmdata

    sfmdata.save(sfmdata.load(args.input), args.output)


def _pipeline(args):
    from .runner import run_full_pipeline

    run_full_pipeline(
        args.imageFolder, args.output, method=args.method, max_keypoints=args.maxKeypoints,
        skip_mvs=args.skipMvs, default_focal_px=args.defaultFocalPx, device=args.dev,
    )


def _export_meshlab(args):
    from .. import sfmdata
    from ..sfmdata.export import export_meshlab

    export_meshlab(sfmdata.load(args.input), args.output, args.mesh)


def _export_animated_camera(args):
    from .. import sfmdata
    from ..sfmdata.export import export_animated_camera

    export_animated_camera(sfmdata.load(args.input), args.output, args.fps)


def _import_known_poses(args):
    from .. import sfmdata
    from ..sfmdata.export import import_known_poses

    sc = sfmdata.load(args.input)
    n = import_known_poses(sc, args.poses)
    sfmdata.save(sc, args.output)
    print(json.dumps({"poses_applied": n}))


def _hardware_resources(args):
    """The host and the torch devices (the reference reports jax.devices())."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    info = {
        "backend": args.dev.type,
        "devices": [torch.cuda.get_device_name(i) for i in range(n)] or ["cpu"],
        "process_count": 1,
        "cpu_count": os.cpu_count(),
    }
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal"):
                    info["host_memory_kb"] = int(line.split()[1])
                    break
    except OSError:
        pass
    print(json.dumps(info, indent=1))


def _checkerboard_calibration(args):
    """Zhang calibration over a checkerboard sequence, unit squares
    (the reference cli.py's checkerboardCalibration)."""
    from .cli_ext import checkerboard_calibration

    res, n = checkerboard_calibration(args.inputFolder, args.rows, args.cols, 1.0, args.dev)
    with open(args.output, "w") as f:
        json.dump({"K": res["K"].tolist(), "dist": res["dist"].tolist(), "rms": res["rms"], "n_views": n}, f,
                  indent=1)


def _sfm_transform(args):
    from .. import sfmdata
    from ..sfm import alignment as al

    sc = sfmdata.load(args.input)
    if args.method == "from_poses" and args.reference:
        al.align_to_scene(sc, sfmdata.load(args.reference))
    elif args.method == "from_gps":
        if not args.gpsFile:
            raise SystemExit("from_gps needs --gpsFile")
        with open(args.gpsFile) as f:
            llh = {int(k): tuple(v) for k, v in json.load(f).items()}
        al.align_from_gps(sc, llh)
    elif args.method == "from_markers":
        if not args.markersFile:
            raise SystemExit("from_markers needs --markersFile")
        with open(args.markersFile) as f:
            markers = {int(k): tuple(v) for k, v in json.load(f).items()}
        al.align_from_markers(sc, markers)
    else:
        al.auto_center_scale(sc, target_extent=args.scale)
    sfmdata.save(sc, args.output)


def _quality_evaluation(args):
    from .. import sfmdata
    from ..sfm.alignment import ate_rmse

    print(json.dumps({"ate_rmse": ate_rmse(sfmdata.load(args.input), sfmdata.load(args.groundTruth))}))


def _export(name):
    def run(args):
        from .. import sfmdata
        from ..sfmdata import export

        getattr(export, name)(sfmdata.load(args.input), args.output)

    return run


def _export_usd(args):
    from .. import sfmdata
    from ..mesh import load_obj
    from ..sfmdata.export import export_usd

    mesh = load_obj(args.mesh) if args.mesh else None
    export_usd(sfmdata.load(args.input), args.output, mesh=mesh)


def _convert_mesh(args):
    from ..mesh import load_obj, load_ply_mesh, save_obj, save_ply_mesh

    cols = None
    if args.input.endswith(".ply"):
        v, f, cols = load_ply_mesh(args.input)
    else:
        v, f = load_obj(args.input)
    if args.output.endswith(".ply"):
        save_ply_mesh(args.output, v, f, colors=cols)
    else:
        save_obj(args.output, v, f)


def _sfm_statistics(args):
    from .. import sfmdata
    from ..sfm import statistics as stt

    sc = sfmdata.load(args.input)
    if args.output:
        stats = stt.generate_html_report(sc, args.output, device=args.dev)
    else:
        stats = stt.scene_statistics(sc, device=args.dev)
    print(json.dumps(stats, indent=1))


def rotation_pair_bearings(sc, features: str, matches_path: str, dev) -> dict:
    """{(i, j): (bearings in view i, bearings in view j)} of each matched
    pair of `matches_path`, on `dev`: what panoramaEstimation and nodalSfM
    feed their engine."""
    import torch

    from .. import camera as camm
    from . import stages as st

    intr = sc.intrinsics_table(device=dev)

    def bearings(xy, v):
        row = intr.row(int(sc.view_intrinsic[v]))
        return camm.backproject_ray(row, torch.as_tensor(xy, dtype=torch.float32, device=dev))

    pair_bearings = {}
    for (i, j), m in st.load_matches(matches_path).items():
        fi = st.load_features(features, int(sc.view_ids[i]))
        fj = st.load_features(features, int(sc.view_ids[j]))
        pair_bearings[(i, j)] = (bearings(fi["xy"][m[:, 0]], i), bearings(fj["xy"][m[:, 1]], j))
    return pair_bearings


def _rotation_sfm(args):
    """panoramaEstimation and nodalSfM (one engine in the reference too):
    the bearings of each matched pair, `RotationSfM` with a generator seeded
    0, rotation-only poses at the origin."""
    import numpy as np
    import torch

    from .. import sfmdata
    from ..sfm.rotation_sfm import RotationSfM

    sc = sfmdata.load(args.input)
    pair_bearings = rotation_pair_bearings(sc, args.features, args.matches, args.dev)
    eng = RotationSfM(sc.n_views, float(np.mean(sc.scale)), (float(sc.sizes[0, 0]), float(sc.sizes[0, 1])),
                      device=args.dev)
    R, _ = eng.run(torch.Generator(device=args.dev).manual_seed(0), pair_bearings)
    for v in range(sc.n_views):
        sc.set_pose(v, R[v], np.zeros(3))
    sfmdata.save(sc, args.output)


def _panorama_warping(args):
    import numpy as np
    import torch

    from .. import sfmdata
    from ..image.io import read_image
    from ..panorama import warp_to_equirect

    sc = sfmdata.load(args.input)
    os.makedirs(args.output, exist_ok=True)
    Wp = args.panoWidth
    Hp = Wp // 2
    f32 = dict(dtype=torch.float32, device=args.dev)
    for v in sc.valid_views():
        if not sc.view_paths[v] or not os.path.exists(sc.view_paths[v]):
            continue
        img = read_image(sc.view_paths[v], grayscale=True)
        ii = int(sc.view_intrinsic[v])
        fx, fy = sc.scale[ii]
        pp = sc.offset[ii] + 0.5 * sc.sizes[ii]
        K = torch.tensor([[fx, 0, pp[0]], [0, fy, pp[1]], [0, 0, 1.0]], **f32)
        p = int(sc.view_pose[v])
        warped, mask = warp_to_equirect(torch.as_tensor(img, **f32), K, torch.as_tensor(sc.pose_R[p], **f32),
                                        (Wp, Hp))
        vid = int(sc.view_ids[v])
        np.save(os.path.join(args.output, f"{vid}_warp.npy"), warped.cpu().numpy())
        np.save(os.path.join(args.output, f"{vid}_mask.npy"), mask.cpu().numpy())


def load_warped(folder: str, device):
    """The `<viewId>_warp.npy` / `_mask.npy` pairs of a panoramaWarping
    folder, in file order, as (V, H, W) float32 and bool tensors."""
    import numpy as np
    import torch

    warps, masks = [], []
    for f in sorted(os.listdir(folder)):
        if f.endswith("_warp.npy"):
            warps.append(np.load(os.path.join(folder, f)))
            masks.append(np.load(os.path.join(folder, f.replace("_warp", "_mask"))))
    return torch.as_tensor(np.stack(warps), device=device), torch.as_tensor(np.stack(masks), device=device)


def _panorama_compositing(args):
    from ..image.io import write_image
    from ..panorama import composite_panorama

    write_image(args.output, composite_panorama(*load_warped(args.input, args.dev)).cpu().numpy())


def _split_360_images(args):
    import numpy as np
    import torch

    from ..image.io import read_image, write_image
    from ..image.processing import split_equirect

    pano = read_image(args.input, grayscale=False)
    imgs, K, Rs = split_equirect(torch.as_tensor(pano, device=args.dev), n_splits=args.nbSplits, fov_deg=args.fov,
                                 out_size=args.outSize)
    imgs = imgs.cpu().numpy()
    os.makedirs(args.output, exist_ok=True)
    for i in range(args.nbSplits):
        write_image(os.path.join(args.output, f"split_{i:02d}.png"), imgs[i])
    np.savez(os.path.join(args.output, "cameras.npz"), K=K.cpu().numpy(), R=Rs)


def _image_processing(args):
    import torch

    from ..image import colorspace as cs
    from ..image import processing as ip
    from ..image.io import read_image, write_image

    img = torch.as_tensor(read_image(args.input), device=args.dev)

    def convert(img, src, dst):
        rgb = cs.convert(img[..., :3], src, dst)
        return torch.cat([rgb, img[..., 3:]], -1) if img.shape[-1] > 3 else rgb

    if args.inputColorSpace != "auto" and img.ndim == 3 and img.shape[-1] >= 3:
        img = convert(img, args.inputColorSpace, "linear")
    if args.dcp:
        from ..utils.dcp import DCPProfile

        img = DCPProfile.from_xml(args.dcp).apply(img, cct=args.cct)
    if args.lcp:
        from ..utils.lcp import parse_lcp

        alt = parse_lcp(args.lcp).interpolate(args.focalMm)
        corrections = set(args.lensCorrection.split(","))
        if "vignetting" in corrections:
            img = ip.apply_lcp_vignette(img, alt)
        if "geometry" in corrections:
            img = ip.apply_lcp_geometry(img, alt)
    if args.scale != 1.0:
        img = ip.resize(img, args.scale)
    if args.denoise:
        img = ip.bilateral_denoise(img)
    if args.sharpen > 0:
        img = ip.sharpen(img, args.sharpen)
    if args.contrast != 1.0:
        img = ip.adjust_contrast(img, args.contrast)
    if args.outputColorSpace != "auto" and img.ndim == 3 and img.shape[-1] >= 3:
        # the working space after --inputColorSpace is linear
        img = convert(img, "linear", args.outputColorSpace)
    write_image(args.output, img.cpu().numpy())


def _ldr_brackets(folder: str, n_brackets: int):
    """The bracket images of a folder (sorted by name), their exposures and
    their groups. EXIF exposures where every file has one, else the
    reference's ladder 4**i over the folder's sorted files (ROADMAP §3)."""
    import numpy as np

    from .. import hdr as hdrm
    from ..image.io import read_exif, read_image

    files = sorted(f for f in os.listdir(folder) if f.lower().endswith((".jpg", ".png", ".jpeg", ".tif", ".npy")))
    imgs = np.stack([read_image(os.path.join(folder, f)) for f in files])
    exps = [read_exif(os.path.join(folder, f)).get("exposure_s", 0.0) for f in files]
    if not all(e > 0 for e in exps):
        exps = [4.0**i for i in range(len(files))]
    return imgs, exps, hdrm.estimate_brackets(np.array(exps), n_brackets)


def _ldr_to_hdr_sampling(args):
    import numpy as np

    from .. import hdr as hdrm

    imgs, exps, groups = _ldr_brackets(args.inputFolder, args.nbBrackets)
    lum = imgs.mean(-1) if imgs.ndim == 4 else imgs
    samples, sample_exps = [], []
    for g in groups:
        idx = hdrm.sample_bracket_pixels(lum[g], args.samples)
        samples.append(lum[g].reshape(len(g), -1)[:, idx])
        sample_exps.append(np.array(exps)[g])
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    np.savez_compressed(
        args.output,
        samples=np.concatenate(samples),
        exposures=np.concatenate(sample_exps),
        group_sizes=np.array([len(g) for g in groups]),
    )


def _ldr_to_hdr_calibration(args):
    import numpy as np
    import torch

    from .. import hdr as hdrm

    with np.load(args.input) as z:
        samples, exps, sizes = z["samples"], z["exposures"], z["group_sizes"]
    # Calibrate on the first bracket group (the reference does the same:
    # one response shared across groups).
    n0 = int(sizes[0])
    s0 = torch.as_tensor(samples[:n0], dtype=torch.float32, device=args.dev)
    e0 = torch.as_tensor(exps[:n0], dtype=torch.float32, device=args.dev)
    out = {"method": args.calibrationMethod}
    if args.calibrationMethod == "laguerre":
        out["phi"] = hdrm.laguerre_calibrate(s0, e0).cpu().numpy()
    elif args.calibrationMethod == "grossberg":
        out["coeffs"] = hdrm.grossberg_calibrate(s0, e0).cpu().numpy()
    else:
        out["g"] = hdrm.debevec_calibrate(s0, e0).g.cpu().numpy()
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    np.savez_compressed(args.output, **out)
    print(json.dumps({"method": args.calibrationMethod}))


def _ldr_to_hdr_merge(args):
    import numpy as np
    import torch

    from .. import hdr as hdrm
    from ..image.io import write_image

    imgs, exps, groups = _ldr_brackets(args.inputFolder, args.nbBrackets)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    response = None
    if args.response:
        with np.load(args.response, allow_pickle=True) as z:
            method = str(z["method"])
            key = {"laguerre": "phi", "grossberg": "coeffs", "debevec": "g"}[method]
            response = (method, np.asarray(z[key]))
    for gi, g in enumerate(groups):
        sub = torch.as_tensor(imgs[g], device=args.dev)
        ex = torch.as_tensor(np.array(exps)[g], dtype=torch.float32, device=args.dev)
        if response is not None:
            merged = hdrm.merge_hdr(sub, ex, response=response)
        else:
            lum = imgs[g].mean(-1) if imgs.ndim == 4 else imgs[g]
            idx = hdrm.sample_bracket_pixels(lum, 800)
            flat = torch.as_tensor(lum.reshape(len(g), -1)[:, idx], device=args.dev)
            merged = hdrm.merge_hdr(sub, ex, phi=hdrm.laguerre_calibrate(flat, ex))
        out = args.output if len(groups) == 1 else args.output.replace(".", f"_{gi}.", 1)
        write_image(out, merged.cpu().numpy())


def _keyframe_selection(args):
    from ..image.io import read_image
    from ..keyframe import select_keyframes_regular, select_keyframes_smart

    if os.path.isdir(args.inputFolder):
        files = sorted(
            f for f in os.listdir(args.inputFolder) if f.lower().endswith((".jpg", ".png", ".jpeg", ".npy"))
        )

        def load():
            return [read_image(os.path.join(args.inputFolder, f), grayscale=True) for f in files]
    else:
        # video input (the reference's mediaPaths accept videos too,
        # ref: dataio/VideoFeed.cpp behind main_keyframeSelection.cpp)
        from ..image.feeds import video_feed

        frames_v, files = [], []
        for img, idx in video_feed(args.inputFolder, grayscale=True):
            frames_v.append(img)
            files.append(f"frame_{idx:06d}")

        def load():
            return frames_v
    if args.method == "regular":
        sel = select_keyframes_regular(len(files), args.step)
    else:
        sel = select_keyframes_smart(load(), device=args.dev)
    with open(args.output, "w") as f:
        for i in sel:
            f.write(files[i] + "\n")


def _image_segmentation(args):
    import numpy as np

    from ..image.io import read_image, write_image
    from ..misc.segmentation import onnx_model, segment_sky, segment_tiled

    img = read_image(args.input)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    if args.modelPath:
        # ref: src/software/pipeline/main_imageSegmentation.cpp: modelPath ->
        # ONNX session -> tiled inference -> labels -> labelsToMask
        score = segment_tiled(img[..., :3], onnx_model(args.modelPath, device=args.dev))
        if score.ndim == 3:
            # several classes: each pixel's label is its argmax, and the mask
            # is the pixels labelled class 0, the foreground class (the JAX
            # CLI thresholds class 0's raw score, ROADMAP §3)
            mask = np.argmax(score, axis=-1) == 0
        else:
            mask = score > args.threshold
    else:
        mask = segment_sky(img, threshold=args.threshold)
    write_image(args.output, mask.astype(np.float32))


def _lidar_merging(args):
    import numpy as np

    from ..mvs import lidar as ld

    scans = ld.load_input_set(args.input)
    pts, org = ld.merge_scans(scans)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    ld.save_cloud_ply(args.output, pts)
    if args.outputOrigins:
        np.save(args.outputOrigins, org)
    print(json.dumps({"points": int(len(pts)), "scans": len(scans)}))


def _lidar_decimating(args):
    import numpy as np

    from ..mvs import lidar as ld

    pts = ld.load_cloud_ply(args.input)
    org = np.load(args.origins) if args.origins else np.zeros_like(pts)
    pts, org = ld.decimate_cloud(pts, org, args.cellSize)
    ld.save_cloud_ply(args.output, pts)
    if args.outputOrigins:
        np.save(args.outputOrigins, org)
    print(json.dumps({"points": int(len(pts))}))


def _lidar_meshing(args):
    import numpy as np

    from ..mesh import save_obj
    from ..mvs import lidar as ld

    if args.input.endswith(".json"):
        pts, org = ld.merge_scans(ld.load_input_set(args.input))
    else:
        pts = ld.load_cloud_ply(args.input)
        org = np.load(args.origins) if args.origins else np.zeros_like(pts)
    v, f = ld.mesh_lidar(pts, org, max_points=args.maxPoints)
    save_obj(args.output, v, f)
    print(json.dumps({"vertices": int(len(v)), "faces": int(len(f))}))


def _import_e57(args):
    from ..mvs import lidar as ld

    scans = ld.read_e57(args.input)
    base, _ = os.path.splitext(args.output)
    entries = []
    for i, (pts, origin) in enumerate(scans):
        ply = f"{base}_scan{i}.ply"
        ld.save_cloud_ply(ply, pts)
        entries.append({"ply": os.path.basename(ply), "origin": list(map(float, origin))})
    with open(args.output, "w") as f:
        json.dump(entries, f)
    print(json.dumps({"scans": len(entries), "points": int(sum(len(p) for p, _ in scans))}))


def _voctree_creation(args):
    """The vocabulary tree of the views' descriptors; its k-means seeds are
    drawn from a generator seeded 0 on the device (the JAX package draws
    from PRNGKey(0))."""
    import numpy as np
    import torch

    from .. import sfmdata
    from ..matching import voctree as vt
    from . import stages as st

    sc = sfmdata.load(args.input)
    descs = []
    for v in range(sc.n_views):
        f = st.load_features(args.features, int(sc.view_ids[v]))
        descs.append(f["desc"][f["valid"]])
    train = torch.from_numpy(np.concatenate(descs)).to(args.dev)
    tree = vt.build_voctree(torch.Generator(device=args.dev).manual_seed(0), train, n_children=args.branching,
                            n_levels=args.levels)
    np.savez_compressed(args.output, centers=tree.centers.cpu().numpy(), n_children=args.branching,
                        n_levels=args.levels)


def _compute_uncertainty(args):
    import numpy as np
    import torch

    from .. import sfmdata
    from ..geometry.rotations import mat_to_quat
    from ..sfm import ba as ba_mod

    sc = sfmdata.load(args.input)
    posed = sc.valid_views()
    R = torch.as_tensor(sc.pose_R[sc.view_pose[posed]], dtype=torch.float32, device=args.dev)
    cam_fixed = np.zeros(len(posed), bool)
    cam_fixed[:1] = True  # gauge (see pose_covariances note)
    problem = ba_mod.build_problem(
        mat_to_quat(R),
        sc.pose_c[sc.view_pose[posed]],
        sc.points,
        sc.intrinsics_table(device=args.dev),
        sc.obs_landmark,
        np.searchsorted(posed, sc.obs_view),
        sc.view_intrinsic[sc.obs_view],
        sc.obs_uv,
        cam_fixed=cam_fixed,
        device=args.dev,
    )
    cov = ba_mod.pose_covariances(problem, problem.cam_q, problem.cam_c, problem.points).cpu().numpy()
    np.savez_compressed(args.output, view_ids=sc.view_ids[posed], covariances=cov)
    print(json.dumps({"mean_trace": float(np.trace(cov, axis1=1, axis2=2).mean())}))


# The subcommands of cli.py; cli_ext.py's registry carries its own handlers.
_HANDLERS = {
    "cameraInit": _camera_init,
    "featureExtraction": _feature_extraction,
    "imageMatching": _image_matching,
    "featureMatching": _feature_matching,
    "incrementalSfm": _incremental_sfm,
    "tracksBuilding": _tracks_building,
    "sfmBootstraping": _sfm_bootstrapping,
    "sfmExpanding": _sfm_expanding,
    "prepareDenseScene": _prepare_dense_scene,
    "depthMapEstimation": _depth_map_estimation,
    "depthMapFiltering": _depth_map_filtering,
    "meshing": _meshing,
    "meshSurface": _mesh_surface,
    "meshFiltering": _mesh_filtering,
    "meshDecimate": _mesh_decimate,
    "meshDenoising": _mesh_denoising,
    "meshResampling": _mesh_resampling,
    "meshMasking": _mesh_masking,
    "texturing": _texturing,
    "convertSfMFormat": _convert_sfm_format,
    "pipeline": _pipeline,
    "exportMeshlab": _export_meshlab,
    "exportAnimatedCamera": _export_animated_camera,
    "importKnownPoses": _import_known_poses,
    "hardwareResources": _hardware_resources,
    "sfmTransform": _sfm_transform,
    "qualityEvaluation": _quality_evaluation,
    "exportColmap": _export("export_colmap"),
    "exportMVE2": _export("export_mve2"),
    "exportPMVS": _export("export_pmvs"),
    "exportUSD": _export_usd,
    "convertMesh": _convert_mesh,
    "sfmStatistics": _sfm_statistics,
    "panoramaEstimation": _rotation_sfm,
    "panoramaWarping": _panorama_warping,
    "panoramaCompositing": _panorama_compositing,
    "split360Images": _split_360_images,
    "imageProcessing": _image_processing,
    "ldrToHdrSampling": _ldr_to_hdr_sampling,
    "ldrToHdrCalibration": _ldr_to_hdr_calibration,
    "ldrToHdrMerge": _ldr_to_hdr_merge,
    "nodalSfM": _rotation_sfm,
    "checkerboardCalibration": _checkerboard_calibration,
    "keyframeSelection": _keyframe_selection,
    "voctreeCreation": _voctree_creation,
    "computeUncertainty": _compute_uncertainty,
    "imageSegmentation": _image_segmentation,
    "lidarMerging": _lidar_merging,
    "lidarDecimating": _lidar_decimating,
    "lidarMeshing": _lidar_meshing,
    "importE57": _import_e57,
}


if __name__ == "__main__":
    sys.exit(main())
