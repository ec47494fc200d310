"""The port's CLI (`pipeline/cli.py`, `pipeline/cli_ext.py`) against the
JAX package's, on the CPU.

- The parser is the JAX `build_parser()`'s: the same subcommands in the same
  order, each with the same flags, defaults, types, choices and help, plus
  `--device` (default "cuda"); only `--profile`'s help differs.
- A small chain run in this process through `cli.main(..., "--device",
  "cpu")` writes the same files, byte for byte, as the port's stages
  called directly with the same arguments.
- Host commands write byte-equal output to the JAX CLI's on the same
  inputs (the exports, mesh filtering, decimation and conversion,
  alignment, view selection, merging, the colored cloud). Where float32
  projections enter (sfmStatistics' residuals, the rendering commands) the
  outputs agree to float32 rounding: the two backends round a projection
  of ~100 px coordinates ~1e-5 px apart.
- In a subprocess, as a farm runs it (tests/test_torch_cli_subprocess.py):
  an empty range exits 0, a missing input exits non-zero with a `fatal`
  line and no traceback, lidarMerging and importE57 run and print their
  JSON, and without `--device cpu` on a machine with no card the command
  fails with the no-CUDA message.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from alicevision_tpu.pipeline import cli as jcli
from alicevision_tpu_torch.mesh import save_obj
from alicevision_tpu_torch.pipeline import cli as tcli
from alicevision_tpu_torch.pipeline import stages

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def _subcommands(ap):
    return next(a for a in ap._actions if a.dest == "cmd").choices


def _signature(p):
    return [(tuple(a.option_strings), a.dest, a.default, a.type, a.required, a.choices, a.nargs, a.const,
             a.help if a.dest != "profile" else None) for a in p._actions]


def test_parser_matches_reference():
    ref, port = _subcommands(jcli.build_parser()), _subcommands(tcli.build_parser())
    assert list(port) == list(ref) and len(ref) == 103
    for name, p in ref.items():
        sig = _signature(port[name])
        dev = [s for s in sig if s[1] == "device"]
        assert dev and dev[0][0] == ("--device",) and dev[0][2] == "cuda", name
        assert [s for s in sig if s[1] != "device"] == _signature(p), name
    args = tcli.build_parser().parse_args(["texturing", "--input", "a", "--mesh", "b", "--images", "c",
                                           "--output", "d"])
    assert (args.device, args.atlasSize, args.multiband, args.multiBandNbContrib) == ("cuda", 2048, True, 4)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli"))
    sfm, _ = chip_smoke.make_posed_scene(root, n_views=3, wh=(256, 192), focal_px=224.0, n_points=300)
    # the same scene with 0.3 px of noise on its observations: statistics
    # of exact projections are float32 rounding, which two backends round
    # differently
    from alicevision_tpu_torch import sfmdata

    sc = sfmdata.load(sfm)
    sc.obs_uv = sc.obs_uv + 0.3 * np.random.RandomState(0).randn(*sc.obs_uv.shape)
    sfmdata.save(sc, os.path.join(root, "noisy.sfm"))
    return root, sfm


def _files(folder):
    out = {}
    for dp, _, names in os.walk(folder):
        for n in names:
            with open(os.path.join(dp, n), "rb") as f:
                out[os.path.relpath(os.path.join(dp, n), folder)] = f.read()
    return out


def test_chain_in_process_writes_the_stages_files(scene, capsys):
    root, sfm = scene
    runs = {}
    for tag in ("cli", "stages"):
        w = os.path.join(root, tag)
        os.makedirs(w)
        d = lambda *p: os.path.join(w, *p)  # noqa: E731
        init = d("cameraInit.sfm")
        if tag == "cli":
            for argv in (
                ["cameraInit", "--imageFolder", os.path.join(root, "images"), "--output", init,
                 "--defaultFocalPx", "224"],
                ["featureExtraction", "--input", init, "--output", d("features"), "--maxKeypoints", "256"],
                ["imageMatching", "--input", init, "--features", d("features"), "--output", d("pairs.txt")],
                ["featureMatching", "--input", init, "--features", d("features"), "--pairs", d("pairs.txt"),
                 "--output", d("matches.npz")],
                ["tracksBuilding", "--input", init, "--features", d("features"), "--matches", d("matches.npz"),
                 "--output", d("tracks.npz")],
                ["prepareDenseScene", "--input", sfm, "--output", d("dense")],
                ["depthMapEstimation", "--input", sfm, "--images", d("dense"), "--output", d("depth"),
                 "--nbDepths", "16"],
                ["depthMapFiltering", "--input", sfm, "--depth", d("depth"), "--output", d("depthf"),
                 "--minConsistent", "2"],
                ["meshSurface", "--input", sfm, "--depth", d("depthf"), "--output", d("mesh.obj")],
                ["meshFiltering", "--input", d("mesh.obj"), "--output", d("filtered.obj"), "--clean",
                 "--fillHolesMaxEdges", "8"],
                ["texturing", "--input", sfm, "--mesh", d("filtered.obj"), "--images", d("dense"), "--depth",
                 d("depth"), "--output", d("textured.obj"), "--atlasSize", "256"],
            ):
                assert tcli.main(argv + CPU) == 0, argv
        else:
            from alicevision_tpu_torch.mesh import clean_mesh, largest_component, load_obj
            from alicevision_tpu_torch.mesh.ops import laplacian_smooth

            stages.camera_init(os.path.join(root, "images"), init, None, 224.0, device="cpu")
            stages.feature_extraction(init, d("features"), 256, False, 0, -1, 1024, describer_types="dspsift",
                                      device="cpu")
            stages.image_matching(init, d("features"), d("pairs.txt"), "exhaustive", 10, device="cpu")
            stages.feature_matching(init, d("features"), d("pairs.txt"), d("matches.npz"), 0.8, "fundamental",
                                    device="cpu")
            stages.tracks_building(init, d("features"), d("matches.npz"), d("tracks.npz"), 2, device="cpu")
            stages.prepare_dense_scene(sfm, d("dense"), device="cpu")
            stages.depth_map_estimation(sfm, d("dense"), d("depth"), 16, 4, 2, device="cpu")
            stages.depth_map_filtering(sfm, d("depth"), d("depthf"), 2, 2, device="cpu")
            stages.meshing_surface(sfm, d("depthf"), d("mesh.obj"), device="cpu")
            v, f = clean_mesh(*load_obj(d("mesh.obj")), fill_holes_max_edges=8)
            v, f = largest_component(v, f)
            save_obj(d("filtered.obj"), laplacian_smooth(torch.as_tensor(v, dtype=torch.float32), f, 5).numpy(), f)
            from alicevision_tpu_torch.mesh.uv_atlas import generate_textured_mesh

            sc = stages.sfmdata.load(sfm)
            V, F = load_obj(d("filtered.obj"))
            imgs, Ks, Rs, cs, dms = [], [], [], [], []
            for vi in sc.valid_views():
                vid = int(sc.view_ids[vi])
                imgs.append(np.load(d("dense", f"{vid}.npy"))[::2, ::2])
                Ks.append(stages._K(sc, int(sc.view_intrinsic[vi]), 2, np.float64))
                Rs.append(sc.pose_R[sc.view_pose[vi]])
                cs.append(sc.pose_c[sc.view_pose[vi]])
                dms.append(np.load(d("depth", f"{vid}_depth.npy")))
            generate_textured_mesh(V, F, imgs, np.stack(Ks), np.stack(Rs), np.stack(cs), d("textured.obj"),
                                   depth_maps=dms, atlas_size=256, device="cpu")
        runs[tag] = _files(w)
    assert "texturing_seconds" in capsys.readouterr().out
    assert len(runs["cli"]) > 20 and set(runs["cli"]) == set(runs["stages"])
    differ = sorted(k for k in runs["cli"] if runs["cli"][k] != runs["stages"][k] and not k.endswith(".sfm"))
    assert not differ, differ
    # .sfm files name their images by path, which differs between the two folders
    for k in (k for k in runs["cli"] if k.endswith(".sfm")):
        assert runs["cli"][k].replace(b"/cli/", b"/stages/") == runs["stages"][k], k


def _mesh(path, seed=0):
    from scipy.spatial import ConvexHull

    rng = np.random.RandomState(seed)
    P = rng.randn(200, 3)
    P /= np.linalg.norm(P, axis=1, keepdims=True)
    F = ConvexHull(P).simplices
    F = np.concatenate([F, F[:2], [[F[5, 0], F[5, 1], F[9, 2]]]])  # a duplicate and a fin for the cleaner
    save_obj(path, (P + 0.02 * rng.randn(*P.shape)).astype(np.float32), F[3:])


HOST_COMMANDS = {
    "convertSfMFormat": lambda s, m, o: ["--input", s, "--output", o("scene.sfm")],
    "convertSfMFormat_ply": lambda s, m, o: ["--input", s, "--output", o("scene.ply")],
    "exportColmap": lambda s, m, o: ["--input", s, "--output", o("colmap")],
    "exportMeshlab": lambda s, m, o: ["--input", s, "--output", o("meshlab"), "--mesh", m],
    "exportMVE2": lambda s, m, o: ["--input", s, "--output", o("mve")],
    "exportPMVS": lambda s, m, o: ["--input", s, "--output", o("pmvs")],
    "exportUSD": lambda s, m, o: ["--input", s, "--output", o("scene.usda"), "--mesh", m],
    "meshFiltering": lambda s, m, o: ["--input", m, "--output", o("f.obj"), "--clean", "--fillHolesMaxEdges", "8"],
    "meshDecimate": lambda s, m, o: ["--input", m, "--output", o("d.obj"), "--targetFaces", "150"],
    "meshDecimate_grid": lambda s, m, o: ["--input", m, "--output", o("g.obj"), "--cellSize", "0.2"],
    "convertMesh": lambda s, m, o: ["--input", m, "--output", o("m.ply")],
    "sfmTransform": lambda s, m, o: ["--input", s, "--output", o("t.sfm"), "--scale", "2.5"],
    "sfmAlignment": lambda s, m, o: ["--input", s, "--reference", s, "--output", o("a.sfm")],
    "mergeMeshes": lambda s, m, o: ["--input", m, "--input2", m, "--output", o("merged.obj"), "--weldEps", "1e-3"],
    "exportColoredPointCloud": lambda s, m, o: ["--input", s, "--imagesFolder", os.path.join(os.path.dirname(s),
                                                "images"), "--output", o("colored.ply")],
}


@pytest.mark.parametrize("name", sorted(HOST_COMMANDS))
def test_host_commands_byte_equal(scene, tmp_path, name, capsys):
    root, sfm = scene
    mesh = str(tmp_path / "in.obj")
    _mesh(mesh)
    cmd = name.split("_")[0]
    for tag, main, extra in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
        os.makedirs(tmp_path / tag)
        assert main([cmd, *HOST_COMMANDS[name](sfm, mesh, lambda p: str(tmp_path / tag / p)), *extra]) == 0
    a, b = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert a and a == b


def _residual_bars(html):
    """The residual histogram's bar heights, and the report without them."""
    import re

    head, rest = html.split("<h2>Reprojection residuals (px)</h2>")
    bars, tail = rest.split("<h2>Track lengths</h2>")
    return [float(h) for h in re.findall(r'height="([0-9.]+)" fill', bars)], head + tail


def _close_stats(a, b):
    """Two sfmStatistics JSON objects: equal, but the residuals within
    rtol 1e-4 (float32 projections round differently on two backends: about
    1e-5 px on this scene's ~100 px coordinates)."""
    for key, val in a.items():
        if key == "residuals_px":
            for k, x in val.items():
                np.testing.assert_allclose(b[key][k], x, rtol=1e-4)
        else:
            assert b[key] == val, key


def test_sfm_statistics_match(scene, tmp_path, capsys):
    """The report's table and track histogram equal; in its residual
    histogram at most one residual changes bin, to a neighbour (a residual
    1e-5 px from a bin edge may fall on either side)."""
    root, sfm = scene
    noisy = os.path.join(root, "noisy.sfm")
    out = {}
    for tag, main, extra in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
        capsys.readouterr()
        assert main(["sfmStatistics", "--input", noisy, "--output", str(tmp_path / f"{tag}.html"), *extra]) == 0
        out[tag] = json.loads(capsys.readouterr().out), open(tmp_path / f"{tag}.html").read()
    _close_stats(out["jax"][0], out["port"][0])
    (jb, jrest), (tb, trest) = _residual_bars(out["jax"][1]), _residual_bars(out["port"][1])
    assert trest == jrest and len(tb) == len(jb) == 30
    moved = np.nonzero(np.array(tb) != np.array(jb))[0]
    assert len(moved) == 0 or (len(moved) == 2 and moved[1] == moved[0] + 1), moved


def test_known_poses_and_quality_match(scene, tmp_path, capsys):
    root, sfm = scene
    outs = {}
    for tag, main, extra in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
        o = lambda p: str(tmp_path / f"{tag}_{p}")  # noqa: E731
        capsys.readouterr()
        assert main(["exportAnimatedCamera", "--input", sfm, "--output", o("anim.json"), *extra]) == 0
        assert main(["importKnownPoses", "--input", sfm, "--poses", o("anim.json"), "--output", o("k.sfm"),
                     *extra]) == 0
        assert main(["qualityEvaluation", "--input", o("k.sfm"), "--groundTruth", sfm, *extra]) == 0
        assert main(["sfmStatistics", "--input", os.path.join(root, "noisy.sfm"), *extra]) == 0
        outs[tag] = (capsys.readouterr().out, *(open(o(p), "rb").read() for p in ("anim.json", "k.sfm")))
    assert outs["jax"][1:] == outs["port"][1:]
    j_lines, t_lines = outs["jax"][0].splitlines(), outs["port"][0].splitlines()
    assert j_lines[:2] == t_lines[:2]  # poses_applied, ate_rmse
    _close_stats(json.loads("\n".join(j_lines[2:])), json.loads("\n".join(t_lines[2:])))


def test_rendering_commands_match(scene, tmp_path, capsys):
    root, sfm = scene
    mesh = str(tmp_path / "in.obj")
    _mesh(mesh)
    from alicevision_tpu_torch import sfmdata

    sc = sfmdata.load(sfm)
    sc.pose_c = sc.pose_c * 0 + [0.0, 0.0, -4.0]  # the sphere in front of every camera
    sc.pose_R = np.tile(np.eye(3), (sc.n_poses, 1, 1))
    posed = str(tmp_path / "posed.sfm")
    sfmdata.save(sc, posed)
    for tag, main, extra in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
        o = lambda p: str(tmp_path / tag / p)  # noqa: E731
        for argv in (["depthMapRendering", "--input", posed, "--mesh", mesh, "--output", o("depth")],
                     ["normalMapRendering", "--input", posed, "--mesh", mesh, "--output", o("normal")],
                     ["meshRemoveUnseenFaces", "--input", posed, "--mesh", mesh, "--output", o("seen.obj")]):
            assert main(argv + extra) == 0, argv
    for v in sc.view_ids:
        dj, dt = (np.load(tmp_path / t / "depth" / f"{int(v)}_depth.npy") for t in ("jax", "port"))
        assert (dj > 0).mean() > 0.1
        np.testing.assert_allclose(dt, dj, rtol=1e-5)
        nj, nt = (np.load(tmp_path / t / "normal" / f"{int(v)}_normal.npy") for t in ("jax", "port"))
        assert (np.abs(nt - nj).max(-1) > 1e-6).mean() <= 0.005  # face ids flip on shared edges at most
    assert open(tmp_path / "jax" / "seen.obj").read() == open(tmp_path / "port" / "seen.obj").read()


@pytest.fixture(scope="module")
def tracks(scene):
    """Features, matches and tracks of the scene's images, through the
    port's CLI on the CPU: (features folder, matches file, tracks file)."""
    root, _ = scene
    w = os.path.join(root, "tracks")
    os.makedirs(w)
    d = lambda *p: os.path.join(w, *p)  # noqa: E731
    init = d("cameraInit.sfm")
    for argv in (
        ["cameraInit", "--imageFolder", os.path.join(root, "images"), "--output", init, "--defaultFocalPx", "224"],
        ["featureExtraction", "--input", init, "--output", d("features"), "--maxKeypoints", "256"],
        ["imageMatching", "--input", init, "--features", d("features"), "--output", d("pairs.txt")],
        ["featureMatching", "--input", init, "--features", d("features"), "--pairs", d("pairs.txt"),
         "--output", d("matches.npz")],
        ["tracksBuilding", "--input", init, "--features", d("features"), "--matches", d("matches.npz"),
         "--output", d("tracks.npz")],
    ):
        assert tcli.main(argv + CPU) == 0, argv
    return d("features"), d("matches.npz"), d("tracks.npz")


def test_triangulation_commands_match(scene, tracks, tmp_path, capsys):
    """sfmTriangulation and computeStructureFromKnownPoses (one handler in
    both packages) triangulate the same landmarks to 1e-4 of the scene's
    extent; selectConnectedViews keeps the same views."""
    root, sfm = scene
    features, matches, tracks_npz = tracks
    from alicevision_tpu import sfmdata as jsfm

    for cmd in ("sfmTriangulation", "computeStructureFromKnownPoses"):
        outs = {}
        for tag, main, extra in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
            out = str(tmp_path / f"{cmd}_{tag}.sfm")
            assert main([cmd, "--input", sfm, "--features", features, "--tracks", tracks_npz, "--output", out,
                         *extra]) == 0
            outs[tag] = jsfm.load(out)
        j, t = outs["jax"], outs["port"]
        common, ij, it = np.intersect1d(j.landmark_ids, t.landmark_ids, return_indices=True)
        assert len(common) >= 0.98 * max(j.n_landmarks, t.n_landmarks) and len(common) > 50, cmd
        np.testing.assert_allclose(t.points[it], j.points[ij], atol=1e-4 * np.abs(j.points).max())
    for tag, main, extra in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
        assert main(["selectConnectedViews", "--input", sfm, "--matches", matches,
                     "--output", str(tmp_path / f"{tag}_views.txt"), *extra]) == 0
    assert open(tmp_path / "jax_views.txt").read() == open(tmp_path / "port_views.txt").read()


def _run(*argv, env_extra=None):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "alicevision_tpu_torch.pipeline.cli", *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_profile_writes_a_trace(scene, tmp_path, capsys):
    root, sfm = scene
    assert tcli.main(["sfmStatistics", "--input", sfm, "--profile", str(tmp_path / "prof"), *CPU]) == 0
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json") and os.path.getsize(tmp_path / "prof" / traces[0]) > 0
